"""Baseline JPEG decoding in numpy: the counterpart of PIL's
`Image.open(path).convert("RGB")` for the JPEG files the repository's
datasets hold (CelebA's `img_align_celeba/*.jpg`, ImageNet validation
images, uploads).

The machine that runs the port has no imaging package, so this module
decodes in numpy, to the bytes that libjpeg-turbo's default decode (which
PIL runs) gives:

  - sequential and progressive Huffman frames (SOF0 / SOF1 / SOF2) with
    8-bit samples, 1, 3 or 4 components, sampling factors of 1 or 2
    (4:4:4, 4:2:2, 4:2:0, 4:4:0), 8- and 16-bit quantisation tables,
    optimised Huffman tables, restart intervals (DRI / RSTn), interleaved
    or one-component scans; progressive scans (jdphuff.c: DC first and
    refinement, AC first and refinement with EOB runs and correction bits)
    fill one coefficient array before the inverse DCT;
  - the integer ISLOW inverse DCT (libjpeg-turbo `jidctint.c`) with its
    13-bit constants, descale and range-limit table;
  - "fancy" triangular upsampling of the chroma planes (`jdsample.c`
    `h2v1`, `h2v2` and `h1v2` with their rounding biases; box replication
    where a plane is at most 2 samples wide, as there);
  - the fixed-point YCbCr -> RGB tables of `jdcolor.c`; a 3-component
    file is RGB when an Adobe APP14 segment says transform 0 (or, with no
    JFIF or Adobe segment, its component ids spell R, G, B), as libjpeg
    decides; a 4-component file is CMYK (Adobe transform 0, or no Adobe
    segment) or YCCK (any other transform), which `jdcolor.c`
    ycck_cmyk_convert turns into CMYK; PIL reads either as "CMYK;I", the
    inverted samples Adobe writes.

APPn, COM and the JFIF / EXIF segments are skipped; like PIL, the decoder
does not rotate by the EXIF orientation. Arithmetic-coded, lossless,
hierarchical and 12-bit frames, sampling factors above 2, and progressive
files whose scans leave one of the first ten coefficients unrefined
(libjpeg then smooths the blocks, jdcoefct.c decompress_smooth_data)
raise ValueError naming the file and the feature.

Entropy decoding reads one symbol at a time in Python through 12-bit
lookup tables (a code of 12 bits or less and, where they fit, its extra
bits resolved in one step); the inverse DCT, upsampling and colour
conversion run vectorised over all blocks of the image at once.
"""

from __future__ import annotations

import re
import struct

import numpy as np

__all__ = ["decode_jpeg", "is_jpeg", "MAX_PIXELS"]

# PIL's DecompressionBombError threshold (2 * Image.MAX_IMAGE_PIXELS): every
# decoder of the port refuses a larger image before allocating it
MAX_PIXELS = 2 * 89478485

_SMOOTHED = 10  # coefficients (zigzag 0-9) libjpeg-turbo's block smoothing reads

# zigzag position -> natural (row-major) index, with 16 trailing entries of
# 63 that absorb a run past the block's end in corrupt data, as libjpeg's
# jpeg_natural_order does
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_NATURAL = tuple(_ZIGZAG.tolist()) + (63,) * 16

_SOF_REFUSED = {
    0xC3: "lossless (SOF3)",
    0xC5: "differential sequential (SOF5)", 0xC6: "differential progressive (SOF6)",
    0xC7: "differential lossless (SOF7)", 0xC9: "arithmetic coding (SOF9)",
    0xCA: "arithmetic coding, progressive (SOF10)", 0xCB: "arithmetic coding, lossless (SOF11)",
    0xCD: "arithmetic coding, differential (SOF13)",
    0xCE: "arithmetic coding, differential progressive (SOF14)",
    0xCF: "arithmetic coding, differential lossless (SOF15)",
    0xCC: "arithmetic coding (DAC)", 0xDE: "hierarchical (DHP)",
}

# ISLOW inverse DCT (jidctint.c): CONST_BITS 13, PASS1_BITS 2
_CONST_BITS, _PASS1_BITS = 13, 2
_FIX_0_298631336, _FIX_0_390180644, _FIX_0_541196100 = 2446, 3196, 4433
_FIX_0_765366865, _FIX_0_899976223, _FIX_1_175875602 = 6270, 7373, 9633
_FIX_1_501321110, _FIX_1_847759065, _FIX_1_961570560 = 12299, 15137, 16069
_FIX_2_053119869, _FIX_2_562915447, _FIX_3_072711026 = 16819, 20995, 25172

_PEEK = 12  # bits of a lookup table's index; longer codes take the slow path
_SCAN_END = re.compile(rb"\xff[^\x00\xd0-\xd7\xff]")
_RST = re.compile(rb"\xff[\xd0-\xd7]")


def is_jpeg(raw: bytes) -> bool:
    return raw[:3] == b"\xff\xd8\xff"


def _range_limit_table() -> np.ndarray:
    """libjpeg's post-IDCT range-limit table (jdmaster.c
    prepare_range_limit_table), indexed by the descaled value & 1023:
    x -> x + 128 on [-128, 127], 255 above, 0 below, wrapping as there."""
    t = np.zeros(1024, np.uint8)
    t[:128] = np.arange(128, 256)
    t[128:512] = 255
    t[896:] = np.arange(128)
    return t


_RANGE_LIMIT = _range_limit_table()
_RANGE_LIMIT.flags.writeable = False


def _ycc_tables():
    """jdcolor.c build_ycc_rgb_table: SCALEBITS 16, FIX(x) = x * 2^16 + 0.5."""
    one_half = 1 << 15
    fix = lambda v: int(v * (1 << 16) + 0.5)  # noqa: E731
    x = np.arange(256, dtype=np.int64) - 128
    cr_r = (fix(1.40200) * x + one_half) >> 16
    cb_b = (fix(1.77200) * x + one_half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + one_half
    return cr_r, cb_b, cr_g, cb_g


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()
for _t in (_CR_R, _CB_B, _CR_G, _CB_G):
    _t.flags.writeable = False



class _Huffman:
    """One Huffman table (jdhuff.c): `lut` maps the next 12 bits to (bits
    consumed, run, value, extra bits still to read), with the extra bits
    resolved in the entry where they fit in the 12; an entry of 0 bits
    marks the prefix of a longer code, which `slow` decodes from the
    canonical limits (maxcode / valptr). A code no symbol has decodes as a
    zero DC difference or an end of block, as libjpeg's (which warns and
    returns symbol 0)."""

    def __init__(self, counts: bytes, values: bytes, is_ac: bool):
        if sum(counts) > len(values) or sum(counts) > 256:
            raise ValueError("bad Huffman table")
        self.is_ac = is_ac
        self.values = values
        self._symbols = None
        self.invalid = (16, 63, 0, 0) if is_ac else (16, 0, 0, 0)
        lut = [self.invalid] * (1 << _PEEK)
        self.maxcode = [-1] * 17
        self.valptr = [0] * 17
        self.mincode = [0] * 17
        code = k = 0
        for length in range(1, 17):
            count = counts[length - 1]
            if count:
                self.valptr[length], self.mincode[length] = k, code
                self.maxcode[length] = code + count - 1
            for _ in range(count):
                if length <= _PEEK:
                    lo, hi = code << (_PEEK - length), (code + 1) << (_PEEK - length)
                    lut[lo:hi] = self._entries(values[k], length, lo, hi)
                else:
                    lut[code >> (length - _PEEK)] = (0, 0, 0, 0)
                code += 1
                k += 1
            code <<= 1
        self.lut = lut

    def _entry(self, sym: int, length: int) -> tuple:
        """(bits, run, 0, extra bits) of a symbol; no extra bits: an AC end
        of block (run 63, ends the block; any run below 15 with size 0, as
        libjpeg), a run of 16 zeros (ZRL, run 15) or a zero DC difference."""
        r, s = (sym >> 4, sym & 15) if self.is_ac else (0, sym)
        if self.is_ac and s == 0:
            return (length, 15 if r == 15 else 63, 0, 0)
        return (length, r, 0, s)

    def _entries(self, sym: int, length: int, lo: int, hi: int) -> list:
        length_, r, _, s = self._entry(sym, length)
        if s == 0 or length + s > _PEEK:
            return [(length_, r, 0, s)] * (hi - lo)
        shift, mask = _PEEK - length - s, (1 << s) - 1
        half = 1 << (s - 1)
        out = []
        for i in range(lo, hi):
            x = (i >> shift) & mask
            out.append((length + s, r, x if x >= half else x - mask, 0))
        return out

    def slow(self, w: int, off: int) -> tuple:
        """The entry of a code longer than 12 bits at bit `off` of the
        64-bit window `w`."""
        peek = (w >> (48 - off)) & 0xFFFF
        for length in range(_PEEK + 1, 17):
            code = peek >> (16 - length)
            if code <= self.maxcode[length]:
                return self._entry(
                    self.values[self.valptr[length] + code - self.mincode[length]], length)
        return self.invalid


    def symbol(self, w: int, off: int) -> tuple:
        """(bits, symbol) of the code at bit `off` of the 64-bit window `w`,
        as the progressive scans read them (EOB runs and ZRL keep their run);
        a code no symbol has reads as symbol 0."""
        if self._symbols is None:
            table = [(0, 0)] * (1 << _PEEK)
            for length in range(1, _PEEK + 1):
                for code in range(self.mincode[length], self.maxcode[length] + 1):
                    sym = self.values[self.valptr[length] + code - self.mincode[length]]
                    lo = code << (_PEEK - length)
                    table[lo:lo + (1 << (_PEEK - length))] = [(length, sym)] * (
                        1 << (_PEEK - length))
            self._symbols = table
        entry = self._symbols[(w >> (52 - off)) & 0xFFF]
        if entry[0]:
            return entry
        peek = (w >> (48 - off)) & 0xFFFF
        for length in range(_PEEK + 1, 17):
            code = peek >> (16 - length)
            if code <= self.maxcode[length]:
                return length, self.values[self.valptr[length] + code - self.mincode[length]]
        return 16, 0


def _windows(data: bytes) -> list:
    """The 64-bit big-endian window at every byte offset of `data` (zeros
    past its end, as libjpeg fills a segment that ends early)."""
    b = np.frombuffer(data + bytes(16), np.uint8).astype(np.uint64)
    n = len(data) + 8
    w = np.zeros(n, np.uint64)
    for j in range(8):
        w |= b[j:j + n] << np.uint64(56 - 8 * j)
    return w.tolist()


def _decode_blocks(data: bytes, bases: list, pattern: list, start: int, stop: int,
                   idx: list, val: list) -> None:
    """Entropy-decode blocks `start:stop` of a scan (one restart interval)
    from its unstuffed bytes: each block's DC difference (per component
    predictor, reset at the interval's start) and AC run / size symbols,
    appending every non-zero coefficient's flat index and value."""
    W = _windows(data)
    ia, va = idx.append, val.append
    nat = _NATURAL
    npat = len(pattern)
    preds = [0] * npat
    pos = 0
    try:
        for b in range(start, stop):
            ci, dct, act = pattern[b % npat]
            dclut, aclut = dct.lut, act.lut
            base = bases[b]
            off = pos & 7
            w = W[pos >> 3]
            L, _, v, s = dclut[(w >> (52 - off)) & 0xFFF]
            if L == 0:
                L, _, v, s = dct.slow(w, off)
            if s:
                x = (w >> (64 - off - L - s)) & ((1 << s) - 1)
                v = x if x >> (s - 1) else x - (1 << s) + 1
                L += s
            pos += L
            p = preds[ci] + v
            preds[ci] = p
            if p:
                ia(base)
                va(p)
            k = 1
            while k < 64:
                off = pos & 7
                w = W[pos >> 3]
                L, r, v, s = aclut[(w >> (52 - off)) & 0xFFF]
                if L == 0:
                    L, r, v, s = act.slow(w, off)
                if s:
                    x = (w >> (64 - off - L - s)) & ((1 << s) - 1)
                    v = x if x >> (s - 1) else x - (1 << s) + 1
                    L += s
                pos += L
                k += r
                if v:
                    ia(base + nat[k])
                    va(v)
                k += 1
    except IndexError:
        raise ValueError("corrupt or truncated JPEG data") from None


def _decode_progressive(data: bytes, bases: list, pattern: list, start: int, stop: int,
                        coefs: list, ss: int, se: int, ah: int, al: int) -> None:
    """Decode blocks `start:stop` of a progressive scan (one restart
    interval; jdphuff.c) from its unstuffed bytes into `coefs` (flat,
    natural order): DC first (differences shifted by Al) or refinement
    (one bit), AC first (run / size symbols, EOB runs) or refinement
    (new +-1 << Al coefficients and correction bits of the non-zero ones)."""
    W = _windows(data)
    pos = 0
    nat = _NATURAL
    npat = len(pattern)

    def get(n: int) -> int:
        nonlocal pos
        if n == 0:
            return 0
        v = (W[pos >> 3] >> (64 - (pos & 7) - n)) & ((1 << n) - 1)
        pos += n
        return v

    def sym(table: _Huffman) -> int:
        nonlocal pos
        length, s = table.symbol(W[pos >> 3], pos & 7)
        pos += length
        return s

    def extend(x: int, s: int) -> int:
        return x if x >> (s - 1) else x - (1 << s) + 1

    try:
        if ss == 0 and ah == 0:  # DC first
            preds = [0] * npat
            for b in range(start, stop):
                ci, dct, _ = pattern[b % npat]
                s = sym(dct)
                if s:
                    preds[ci] += extend(get(s), s)
                coefs[bases[b]] = preds[ci] << al
        elif ss == 0:  # DC refinement
            p1 = 1 << al
            for b in range(start, stop):
                if get(1):
                    coefs[bases[b]] |= p1
        elif ah == 0:  # AC first
            act = pattern[0][2]
            eobrun = 0
            for b in range(start, stop):
                if eobrun:
                    eobrun -= 1
                    continue
                base, k = bases[b], ss
                while k <= se:
                    rs = sym(act)
                    r, s = rs >> 4, rs & 15
                    if s:
                        k += r
                        coefs[base + nat[k]] = extend(get(s), s) << al
                    elif r == 15:
                        k += 15
                    else:
                        eobrun = (1 << r) + get(r) - 1
                        break
                    k += 1
        else:  # AC refinement
            act = pattern[0][2]
            p1, m1 = 1 << al, -1 << al
            eobrun = 0
            for b in range(start, stop):
                base, k = bases[b], ss
                if eobrun == 0:
                    while k <= se:
                        rs = sym(act)
                        r, s = rs >> 4, rs & 15
                        if s:
                            s = p1 if get(1) else m1
                        elif r != 15:
                            eobrun = (1 << r) + get(r)
                            break
                        while True:  # past the non-zero ones (correction bits) and r zeros
                            i = base + nat[k]
                            c = coefs[i]
                            if c:
                                if get(1) and not c & p1:
                                    coefs[i] = c + p1 if c >= 0 else c + m1
                            else:
                                r -= 1
                                if r < 0:
                                    break
                            k += 1
                            if k > se:
                                break
                        if s:
                            coefs[base + nat[k]] = s
                        k += 1
                if eobrun > 0:
                    while k <= se:
                        i = base + nat[k]
                        c = coefs[i]
                        if c and get(1) and not c & p1:
                            coefs[i] = c + p1 if c >= 0 else c + m1
                        k += 1
                    eobrun -= 1
    except IndexError:
        raise ValueError("corrupt or truncated JPEG data") from None


class _Component:
    def __init__(self, cid: int, h: int, v: int, tq: int):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq
        self.q = None  # the quantisation table, latched at its first scan
        self.scanned = False
        self.coef_bits = [-1] * 64  # progressive: the Al each coefficient was last scanned at


def _idct_pass(x: np.ndarray, axis: int, shift: int) -> np.ndarray:
    """One 1-D pass of jidctint.c's ISLOW IDCT along `axis` of (N, 8, 8),
    descaled by `shift` bits with rounding."""
    c = [np.take(x, k, axis=axis) for k in range(8)]
    z1 = (c[2] + c[6]) * _FIX_0_541196100
    tmp2 = z1 - c[6] * _FIX_1_847759065
    tmp3 = z1 + c[2] * _FIX_0_765366865
    tmp0 = (c[0] + c[4]) << _CONST_BITS
    tmp1 = (c[0] - c[4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = c[7], c[5], c[3], c[1]
    z5 = (t0 + t2 + t1 + t3) * _FIX_1_175875602
    z1 = (t0 + t3) * -_FIX_0_899976223
    z2 = (t1 + t2) * -_FIX_2_562915447
    z3 = (t0 + t2) * -_FIX_1_961570560 + z5
    z4 = (t1 + t3) * -_FIX_0_390180644 + z5
    t0 = t0 * _FIX_0_298631336 + z1 + z3
    t1 = t1 * _FIX_2_053119869 + z2 + z4
    t2 = t2 * _FIX_3_072711026 + z2 + z3
    t3 = t3 * _FIX_1_501321110 + z1 + z4
    half = 1 << (shift - 1)
    outs = (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)
    return np.stack([(o + half) >> shift for o in outs], axis=axis)


def _idct_islow(coef: np.ndarray) -> np.ndarray:
    """(N, 8, 8) dequantised coefficients (row: vertical frequency) ->
    (N, 8, 8) uint8 samples: columns, then rows, then the range limit."""
    ws = _idct_pass(coef.astype(np.int64), 1, _CONST_BITS - _PASS1_BITS)
    out = _idct_pass(ws, 2, _CONST_BITS + _PASS1_BITS + 3)
    return _RANGE_LIMIT[out & 1023]


def _shifted(x: np.ndarray, axis: int, step: int) -> np.ndarray:
    """x moved by one sample along `axis` (step -1: each sample's
    predecessor, +1: its successor), the edge sample replicated."""
    n = x.shape[axis]
    idx = np.clip(np.arange(n) + step, 0, n - 1)
    return np.take(x, idx, axis=axis)


def _interleave(a: np.ndarray, b: np.ndarray, axis: int) -> np.ndarray:
    out = np.stack([a, b], axis=axis + 1)
    shape = list(a.shape)
    shape[axis] *= 2
    return out.reshape(shape)


def _upsample(p: np.ndarray, hr: int, vr: int) -> np.ndarray:
    """jdsample.c at full size with fancy upsampling on: h2v1 / h2v2
    triangular filters where the plane is wider than 2 samples (box
    replication otherwise), h1v2 triangular always; edges replicated,
    which reproduces the special first and last columns and the context
    rows at the top and bottom."""
    if hr == 1 and vr == 1:
        return p
    x = p.astype(np.int32)
    if hr == 1:  # h1v2
        cs_up = 3 * x + _shifted(x, 0, -1)
        cs_dn = 3 * x + _shifted(x, 0, 1)
        return _interleave((cs_up + 1) >> 2, (cs_dn + 2) >> 2, 0).astype(np.uint8)
    if x.shape[1] <= 2:  # box
        return np.repeat(np.repeat(p, hr, axis=1), vr, axis=0)
    if vr == 1:  # h2v1
        return _interleave((3 * x + _shifted(x, 1, -1) + 1) >> 2,
                           (3 * x + _shifted(x, 1, 1) + 2) >> 2, 1).astype(np.uint8)
    rows = []
    for cs in (3 * x + _shifted(x, 0, -1), 3 * x + _shifted(x, 0, 1)):  # h2v2
        rows.append(_interleave((3 * cs + _shifted(cs, 1, -1) + 8) >> 4,
                                (3 * cs + _shifted(cs, 1, 1) + 7) >> 4, 1))
    return _interleave(rows[0], rows[1], 0).astype(np.uint8)


def _ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray, clip: bool = True) -> np.ndarray:
    """jdcolor.c ycc_rgb_convert with its tables and sample range limit
    (clip=False: the sums before the limit, as ycck_cmyk_convert takes them)."""
    y = y.astype(np.int64)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    out = np.stack([r, g, b], axis=-1)
    return np.clip(out, 0, 255).astype(np.uint8) if clip else out


def decode_jpeg(raw: bytes, name: str = "<bytes>") -> np.ndarray:
    """JPEG bytes -> uint8 (H, W) for a 1-component file, (H, W, 3) RGB for
    3 components, (H, W, 4) CMYK (PIL's "CMYK" mode) for 4, as
    libjpeg-turbo's default decode. `name` labels errors."""

    def refuse(feature: str):
        raise ValueError(f"{name}: {feature} JPEG is not supported (Huffman-coded "
                         "8-bit only; see ROADMAP.md)")

    if not is_jpeg(raw):
        raise ValueError(f"{name}: not a JPEG file")
    qt: dict = {}
    tables: dict = {}
    comps: list = []
    width = height = restart = 0
    progressive = False
    jfif, adobe = False, None
    idx: list = []
    val: list = []
    coefs: list | None = None
    pos, n = 2, len(raw)
    while True:
        while pos < n and raw[pos] != 0xFF:  # stray bytes before a marker
            pos += 1
        while pos < n and raw[pos] == 0xFF:  # fill bytes
            pos += 1
        if pos >= n:
            if comps and all(c.scanned for c in comps):
                break  # no EOI after complete scans: libjpeg warns and ends
            raise ValueError(f"{name}: truncated JPEG file")
        marker = raw[pos]
        pos += 1
        if marker == 0xD9:  # EOI
            break
        if marker in (0x01, 0xD8) or 0xD0 <= marker <= 0xD7:
            continue
        if pos + 2 > n:
            raise ValueError(f"{name}: truncated JPEG file")
        (length,) = struct.unpack_from(">H", raw, pos)
        seg = raw[pos + 2:pos + length]
        pos += length
        if marker in _SOF_REFUSED:
            refuse(_SOF_REFUSED[marker])
        if marker in (0xC0, 0xC1, 0xC2):
            progressive = marker == 0xC2
            precision, height, width, nf = struct.unpack_from(">BHHB", seg)
            if precision != 8:
                refuse(f"{precision}-bit")
            if nf not in (1, 3, 4):
                refuse(f"{nf}-component")
            if height == 0 or width == 0:
                refuse("a DNL-defined height (or empty)")
            if width * height > MAX_PIXELS:
                raise ValueError(f"{name}: {width} x {height} pixels is more than "
                                 f"{MAX_PIXELS} (a decompression bomb to PIL)")
            comps = []
            for i in range(nf):
                cid, hv, tq = seg[6 + 3 * i:9 + 3 * i]
                if not (1 <= hv >> 4 <= 2 and 1 <= hv & 15 <= 2):
                    refuse(f"sampling factor {hv >> 4}x{hv & 15} (above 2)")
                comps.append(_Component(cid, hv >> 4, hv & 15, tq))
        elif marker == 0xC4:  # DHT: one or more tables
            i = 0
            while i < len(seg):
                tc_th, counts = seg[i], seg[i + 1:i + 17]
                total = sum(counts)
                tables[(tc_th >> 4, tc_th & 15)] = _Huffman(
                    counts, seg[i + 17:i + 17 + total], is_ac=bool(tc_th >> 4))
                i += 17 + total
        elif marker == 0xDB:  # DQT: 8- or 16-bit tables
            i = 0
            while i < len(seg):
                pq_tq = seg[i]
                if pq_tq >> 4:
                    zz = np.frombuffer(seg[i + 1:i + 129], ">u2")
                    i += 129
                else:
                    zz = np.frombuffer(seg[i + 1:i + 65], np.uint8)
                    i += 65
                q = np.zeros(64, np.int64)
                q[_ZIGZAG] = zz
                qt[pq_tq & 15] = q
        elif marker == 0xDD:  # DRI
            (restart,) = struct.unpack_from(">H", seg)
        elif marker == 0xE0 and len(seg) >= 14 and seg[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and len(seg) >= 12 and seg[:5] == b"Adobe":
            adobe = seg[11]
        elif marker == 0xDA:  # SOS
            if not comps:
                raise ValueError(f"{name}: scan before the frame header")
            if progressive and coefs is None:
                coefs = [0] * (64 * _layout(comps, width, height)[4])
            pos = _scan(raw, pos, seg, comps, qt, tables, width, height, restart,
                        idx, val, coefs, name)
    if not comps or not all(c.scanned for c in comps):
        raise ValueError(f"{name}: JPEG without image data for every component")
    if progressive:
        # libjpeg-turbo smooths blocks (jdcoefct.c smoothing_ok) when every
        # DC is known and one of the first ten coefficients is not exact
        if (all(c.coef_bits[0] >= 0 for c in comps)
                and any(b != 0 for c in comps for b in c.coef_bits[1:_SMOOTHED])):
            refuse("progressive with unrefined low coefficients (libjpeg block smoothing)")
        coef = np.asarray(coefs, np.int64)
    else:
        coef = np.zeros(64 * _layout(comps, width, height)[4], np.int64)
        coef[np.asarray(idx, np.int64)] = val
    return _reconstruct(comps, width, height, coef, jfif, adobe)


def _layout(comps: list, width: int, height: int):
    """Per component: its blocks' offset in the image's block array, its
    block columns and rows (whole MCUs), and its downsampled size."""
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    mcux = -(-width // (8 * hmax))
    mcuy = -(-height // (8 * vmax))
    offset = 0
    for c in comps:
        c.bw, c.bh = mcux * c.h, mcuy * c.v
        c.offset = offset
        offset += c.bw * c.bh
        c.ds_w = -(-width * c.h // hmax)
        c.ds_h = -(-height * c.v // vmax)
    return hmax, vmax, mcux, mcuy, offset


def _scan(raw, pos, seg, comps, qt, tables, width, height, restart, idx, val, coefs,
          name) -> int:
    """Decode one scan that starts at `pos` (sequential into idx / val,
    progressive into coefs); returns the offset just past its
    entropy-coded data."""
    ns = seg[0]
    by_id = {c.cid: c for c in comps}
    scomps, pattern = [], []
    hmax, vmax, mcux, mcuy, _ = _layout(comps, width, height)
    ss, se, ahal = seg[1 + 2 * ns:4 + 2 * ns]
    ah, al = ahal >> 4, ahal & 15
    if coefs is None:
        if ss != 0 or se != 63 or ahal != 0:
            raise ValueError(f"{name}: spectral selection or successive approximation in a "
                             "sequential scan")
        need_dc = need_ac = True
    else:  # jdphuff.c start_pass_phuff_decoder's checks
        if ((ss == 0 and se != 0) or (ss and (se < ss or se > 63 or ns != 1))
                or (ah and al != ah - 1) or al > 13):
            raise ValueError(f"{name}: bad progressive scan parameters "
                             f"(Ss {ss}, Se {se}, Ah {ah}, Al {al})")
        need_dc, need_ac = ss == 0 and ah == 0, ss > 0
    for i in range(ns):
        cid, tdta = seg[1 + 2 * i], seg[2 + 2 * i]
        if cid not in by_id:
            raise ValueError(f"{name}: scan names an unknown component {cid}")
        c = by_id[cid]
        if c.q is None:
            if c.tq not in qt:
                raise ValueError(f"{name}: no quantisation table {c.tq}")
            c.q = qt[c.tq].copy()
        c.scanned = True
        try:
            dct = tables[(0, tdta >> 4)] if need_dc else None
            act = tables[(1, tdta & 15)] if need_ac else None
        except KeyError:
            raise ValueError(f"{name}: scan uses an undefined Huffman table") from None
        if coefs is not None:
            c.coef_bits[ss:se + 1] = [al] * (se + 1 - ss)
        scomps.append((c, dct, act))
    if ns == 1:  # non-interleaved: one block an MCU over the component's own extent
        c, dct, act = scomps[0]
        rows, cols = -(-c.ds_h // 8), -(-c.ds_w // 8)
        r, q = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
        bases = (c.offset + r * c.bw + q).reshape(-1)
        pattern = [(0, dct, act)]
    else:
        my, mx = np.meshgrid(np.arange(mcuy), np.arange(mcux), indexing="ij")
        my, mx = my.reshape(-1), mx.reshape(-1)
        cols = []
        for ci, (c, dct, act) in enumerate(scomps):
            for v in range(c.v):
                for h in range(c.h):
                    cols.append(c.offset + (my * c.v + v) * c.bw + mx * c.h + h)
                    pattern.append((ci, dct, act))
        bases = np.stack(cols, axis=1).reshape(-1)
    bases = (bases * 64).tolist()
    m = _SCAN_END.search(raw, pos)
    end = m.start() if m else len(raw)
    data = raw[pos:end]
    npat = len(pattern)
    total = len(bases)
    per = restart * npat if restart else total
    pieces = _RST.split(data) if restart else [data]
    need = -(-total // per)
    if len(pieces) < need:
        raise ValueError(f"{name}: corrupt JPEG data: {len(pieces)} restart intervals, "
                         f"{need} expected")
    for i in range(need):
        piece = pieces[i].replace(b"\xff\x00", b"\xff")
        stop = min((i + 1) * per, total)
        try:
            if coefs is None:
                _decode_blocks(piece, bases, pattern, i * per, stop, idx, val)
            else:
                _decode_progressive(piece, bases, pattern, i * per, stop, coefs, ss, se, ah, al)
        except ValueError as e:
            raise ValueError(f"{name}: {e}") from None
    return end


def _reconstruct(comps, width, height, coef, jfif, adobe) -> np.ndarray:
    """Coefficients (flat, natural order) -> dequantised -> IDCT -> planes
    -> upsampled -> colour converted."""
    hmax, vmax, _, _, nblocks = _layout(comps, width, height)
    coef = coef.reshape(nblocks, 64)
    for c in comps:
        coef[c.offset:c.offset + c.bw * c.bh] *= c.q
    samples = _idct_islow(coef.reshape(nblocks, 8, 8))
    planes = []
    for c in comps:
        blocks = samples[c.offset:c.offset + c.bw * c.bh].reshape(c.bh, c.bw, 8, 8)
        plane = blocks.transpose(0, 2, 1, 3).reshape(c.bh * 8, c.bw * 8)[:c.ds_h, :c.ds_w]
        planes.append(_upsample(plane, hmax // c.h, vmax // c.v)[:height, :width])
    if len(planes) == 1:
        return np.ascontiguousarray(planes[0])
    if len(planes) == 4:
        if adobe is not None and adobe != 0:  # YCCK -> CMYK (jdcolor.c ycck_cmyk_convert)
            cmy = 255 - _ycc_to_rgb(*planes[:3], clip=False)
            planes = [*np.moveaxis(np.clip(cmy, 0, 255).astype(np.uint8), -1, 0), planes[3]]
        return 255 - np.stack(planes, axis=-1)  # PIL's "CMYK;I"
    if jfif:
        rgb = False
    elif adobe is not None:
        rgb = adobe == 0
    else:
        rgb = [c.cid for c in comps] == [82, 71, 66]  # 'R', 'G', 'B'
    if rgb:
        return np.stack(planes, axis=-1)
    return _ycc_to_rgb(*planes)
