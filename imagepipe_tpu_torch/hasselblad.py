"""Hasselblad compressed 3FR codec.

The reference reaches Hasselblad backs through rawloader at
the reference's src/pipeline.rs:264. A compressed 3FR is a TIFF-EP
container whose raw CFA IFD carries TIFF compression 7 (JPEG) — but the
strip payload is NOT baseline lossless JPEG. Following the public dcraw
`hasselblad_load_raw` semantics:

- The embedded JPEG header supplies only the Huffman table (DHT) and the
  predictor-selection value (the first byte after the component specs in
  the SOS segment, "Ss"/psv). Frame dimensions come from the TIFF tags;
  the SOF3 marker typically declares two components at half width.
- Scan data after SOS is consumed as 32-bit LITTLE-ENDIAN words, bits
  MSB-first within each word (the Phase One bit order) with NO JPEG FF
  byte stuffing.
- Columns pair: per pair, two Huffman-coded difference lengths are
  decoded first, then the two difference values. Sign handling is the
  JPEG "extend" rule (top bit clear => v -= 2^len - 1) plus one special:
  a 16-bit field of 65535 decodes to -32768.
- Predictor: 0x8000 at the first column pair of every row; otherwise the
  value two columns back in the SAME row (the same-CFA-color neighbor).
  With psv 11 (H5D-generation backs) the half-difference of the
  row-TWO-above values is added — C truncating-toward-zero division, on
  the UNMASKED running predictors. Any other psv adds no correction.
- The stored sample is the low 16 bits of the predictor; the unmasked
  predictor (which may leave [0, 65535]) is what neighbors see.

The row-2 reference is self-consistent with the Bayer mosaic (rows of
the same color pair are two apart), which is why the 2-D correction only
applies from row 2 and the in-row reference skips one column pair.

The decoder prefers the native C++ twin (native/hasselblad.cc, via
ctypes) and falls back to pure Python. The canonical encoder exists for
tests: the scheme is lossless, so decode(encode(x)) round-trips pin the
bit layout, python<->native differential fuzz pins the two decoders to
each other, and — as with every recalled vendor codec here — the layout
awaits real-file confirmation (tests/test_realfiles.py flags it).

Multi-shot files (SamplesPerPixel > 1) are refused by name: the
multi-sample interleave doubles the per-pair symbol count and the
half-pixel registration is untestable without real files.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from . import native

__all__ = ["decode_hasselblad", "encode_hasselblad", "parse_jpeg_header"]

# Refills allowed to start past the physical end of the scan (the
# encoder zero-pads to a word boundary; Huffman PEEKS may look a few
# bits past the last data bit). Shared with native/hasselblad.cc.
_MAX_PAST_END_REFILLS = 2


def _c_div2(v: int) -> int:
    """C `v / 2`: truncation toward zero (Python // floors)."""
    return v // 2 if v >= 0 else -((-v) // 2)


def parse_jpeg_header(data: bytes):
    """Walk the embedded JPEG header. Returns (huff, psv, scan_pos):
    `huff` maps (code_length, code) -> difference length for table 0,
    `psv` the SOS predictor byte, `scan_pos` the offset of the first
    scan byte (where the 32-bit-word bit stream begins)."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("3FR: strip payload is not a JPEG stream")
    pos = 2
    huffs: dict[int, dict] = {}
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            raise ValueError("3FR: bad JPEG marker alignment")
        marker = data[pos + 1]
        pos += 2
        if marker == 0xD8:
            continue
        seglen = (data[pos] << 8) | data[pos + 1]
        if seglen < 2 or pos + seglen > len(data):
            raise ValueError("3FR: truncated JPEG segment")
        seg = data[pos + 2:pos + seglen]
        if marker == 0xC4:  # DHT
            q = 0
            while q + 17 <= len(seg):
                th = seg[q] & 0x0F
                q += 1
                counts = list(seg[q:q + 16])
                q += 16
                nvals = sum(counts)
                if q + nvals > len(seg):
                    raise ValueError("3FR: truncated DHT")
                huffs[th] = _build_huff(counts, list(seg[q:q + nvals]))
                q += nvals
            pos += seglen
        elif marker == 0xDA:  # SOS: psv byte, then scan data
            ns = seg[0]
            if len(seg) < 1 + ns * 2 + 1:
                raise ValueError("3FR: truncated SOS")
            psv = seg[1 + ns * 2]
            if 0 not in huffs:
                raise ValueError("3FR: SOS before Huffman table 0")
            return huffs[0], int(psv), pos + seglen
        else:  # SOF3, APPn, COM... dims come from the TIFF tags
            pos += seglen
    raise ValueError("3FR: no SOS marker in JPEG stream")


def _build_huff(counts, vals):
    """Canonical JPEG code assignment -> {(length, code): value}."""
    table = {}
    code = 0
    k = 0
    for ln in range(1, 17):
        for _ in range(counts[ln - 1]):
            table[(ln, code)] = vals[k]
            code += 1
            k += 1
        code <<= 1
    return table


def _lookup_from_huff(huff) -> tuple[int, np.ndarray]:
    """Flatten the code dict into a peek table: index by the next
    `maxlen` bits, entry = (code_length << 8) | value (dcraw's
    make_decoder layout, what ph1_bithuff expects)."""
    maxlen = max(ln for ln, _ in huff)
    table = np.zeros(1 << maxlen, np.uint16)
    for (ln, code), val in huff.items():
        if val > 16:
            # Values are difference-field lengths; >16 would shift past
            # the 16-bit sample width (and past both readers' caches).
            raise ValueError("3FR: difference length out of range")
        base = code << (maxlen - ln)
        table[base:base + (1 << (maxlen - ln))] = (ln << 8) | val
    # Unassigned peek patterns keep entry 0: a zero code LENGTH, which
    # both decoders reject (consuming 0 bits would loop forever).
    return maxlen, table


class _Ph1Bits:
    """dcraw ph1_bits for the Hasselblad scan: 32-bit little-endian
    words, bits MSB-first, 64-bit cache, with PEEK support for the
    Huffman lookup. Refills may start past the physical end (zero
    words) at most _MAX_PAST_END_REFILLS times."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos
        self.bitbuf = 0
        self.vbits = 0
        self.past_end = 0

    def _refill(self) -> None:
        if self.pos >= len(self.data):
            self.past_end += 1
            if self.past_end > _MAX_PAST_END_REFILLS:
                raise ValueError("3FR: bitstream exhausted")
            w = 0
        else:
            chunk = self.data[self.pos:self.pos + 4]
            w = int.from_bytes(chunk, "little")  # short tail zero-pads
        self.pos += 4
        self.bitbuf = ((self.bitbuf << 32) | w) & 0xFFFFFFFFFFFFFFFF
        self.vbits += 32

    def peek(self, n: int) -> int:
        if self.vbits < n:
            self._refill()
        return ((self.bitbuf << (64 - self.vbits))
                & 0xFFFFFFFFFFFFFFFF) >> (64 - n)

    def skip(self, n: int) -> None:
        self.vbits -= n

    def get(self, n: int) -> int:
        if n == 0:
            return 0
        v = self.peek(n)
        self.vbits -= n
        return v


def _extend(v: int, ln: int) -> int:
    """Difference sign rule: JPEG extend plus the 65535 -> -32768
    special (dcraw hasselblad_load_raw)."""
    if ln == 0:
        return 0
    if not (v & (1 << (ln - 1))):
        v -= (1 << ln) - 1
    if v == 65535:
        v = -32768
    return v


def _decode_python(scan: bytes, width: int, height: int, huff,
                   psv: int) -> np.ndarray:
    maxlen, table = _lookup_from_huff(huff)
    br = _Ph1Bits(scan)
    out = np.zeros((height, width), np.uint16)
    cur = [0] * width    # running predictors, current row (unmasked)
    prev2 = [0] * width  # row-2 predictors
    prev1 = [0] * width
    corr = psv == 11
    for row in range(height):
        prev2, prev1, cur = prev1, cur, prev2
        for col in range(0, width, 2):
            e0 = int(table[br.peek(maxlen)])
            if not e0 >> 8:
                raise ValueError("3FR: invalid Huffman code")
            br.skip(e0 >> 8)
            e1 = int(table[br.peek(maxlen)])
            if not e1 >> 8:
                raise ValueError("3FR: invalid Huffman code")
            br.skip(e1 >> 8)
            d0 = _extend(br.get(e0 & 0xFF), e0 & 0xFF)
            d1 = _extend(br.get(e1 & 0xFF), e1 & 0xFF)
            for s, d in ((col, d0), (col + 1, d1)):
                if col == 0:
                    pred = 0x8000
                else:
                    pred = cur[s - 2]
                    if corr and row > 1:
                        pred += _c_div2(prev2[s]) - _c_div2(prev2[s - 2])
                pred += d
                cur[s] = pred
                out[row, s] = pred & 0xFFFF
    return out


def _decode_native(scan: bytes, width: int, height: int, huff,
                   psv: int) -> np.ndarray:
    maxlen, table = _lookup_from_huff(huff)
    lib = native._lib
    fn = lib.hasselblad_decode
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_uint16),
                   ctypes.POINTER(ctypes.c_uint16)]
    out = np.empty((height, width), np.uint16)
    rc = fn(scan, len(scan), width, height, psv, maxlen,
            table.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
    if rc != 0:
        reasons = {2: "bitstream exhausted", 3: "invalid Huffman code"}
        raise ValueError(
            f"3FR: corrupt compressed stream "
            f"({reasons.get(rc, f'rc={rc}')})")
    return out


def decode_hasselblad(payload: bytes, width: int,
                      height: int) -> np.ndarray:
    """Decode a compressed 3FR strip (the full embedded JPEG stream,
    header included) into a (height, width) uint16 mosaic."""
    if width <= 0 or height <= 0 or width % 2:
        raise ValueError("3FR: raw width must be positive and even")
    huff, psv, scan_pos = parse_jpeg_header(bytes(payload))
    scan = bytes(payload[scan_pos:])
    if native.have_native() and hasattr(native._lib, "hasselblad_decode"):
        return _decode_native(scan, width, height, huff, psv)
    return _decode_python(scan, width, height, huff, psv)


# ---------------------------------------------------------------- encode

class _Ph1BitsWriter:
    """Mirror of _Ph1Bits: MSB-first bits into 32-bit little-endian
    words, zero-padded to a word boundary at flush."""

    def __init__(self):
        self.words: list[int] = []
        self.acc = 0
        self.nacc = 0

    def put(self, n: int, v: int) -> None:
        if n == 0:
            return
        self.acc = (self.acc << n) | (v & ((1 << n) - 1))
        self.nacc += n
        while self.nacc >= 32:
            self.words.append((self.acc >> (self.nacc - 32)) & 0xFFFFFFFF)
            self.nacc -= 32
            self.acc &= (1 << self.nacc) - 1

    def flush(self) -> bytes:
        if self.nacc:
            self.put(32 - self.nacc, 0)
        return b"".join(struct.pack("<I", w) for w in self.words)


# Encoder Huffman table: difference lengths 0..16 as canonical 5-bit
# codes (17 of 32 slots used — a legal JPEG table; real files carry
# optimized tables, which parse_jpeg_header handles generally).
_ENC_COUNTS = [0, 0, 0, 0, 17, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0]
_ENC_VALS = list(range(17))
_ENC_CODES = {v: (5, v) for v in range(17)}  # value -> (length, code)


def _diff_len(d: int) -> int:
    if d == 0:
        return 0
    ln = d.bit_length() if d > 0 else (-d).bit_length()
    if ln > 16 or d == 65535:
        raise ValueError("3FR encode: diff out of range")
    return ln


def encode_hasselblad(img: np.ndarray, psv: int = 1) -> bytes:
    """Canonical encoder (tests): emit a JPEG-framed stream that
    decode_hasselblad reproduces exactly. Differences are chosen in
    [-32768, 32767] congruent to target-minus-predictor mod 2^16, so
    any uint16 image round-trips (the predictor may leave [0, 65535];
    decode masks the stored sample exactly like dcraw)."""
    img = np.asarray(img)
    if img.dtype != np.uint16 or img.ndim != 2 or img.shape[1] % 2:
        raise ValueError("3FR encode: need uint16 (h, even-w) image")
    height, width = img.shape

    head = bytearray(b"\xff\xd8")
    # SOF3: 16-bit precision, two components at half width (the real
    # files' framing; dims are informational — decode uses TIFF tags).
    sof = struct.pack(">BHHB", 16, height, width // 2, 2)
    sof += bytes((1, 0x11, 0, 2, 0x11, 0))
    head += b"\xff\xc3" + struct.pack(">H", len(sof) + 2) + sof
    dht = bytes([0]) + bytes(_ENC_COUNTS) + bytes(_ENC_VALS)
    head += b"\xff\xc4" + struct.pack(">H", len(dht) + 2) + dht
    sos = bytes((2, 1, 0, 2, 0, psv, 0, 0))
    head += b"\xff\xda" + struct.pack(">H", len(sos) + 2) + sos

    bw = _Ph1BitsWriter()
    cur = [0] * width
    prev2 = [0] * width
    prev1 = [0] * width
    corr = psv == 11
    for row in range(height):
        prev2, prev1, cur = prev1, cur, prev2
        for col in range(0, width, 2):
            diffs = []
            for s in (col, col + 1):
                if col == 0:
                    pred = 0x8000
                else:
                    pred = cur[s - 2]
                    if corr and row > 1:
                        pred += _c_div2(prev2[s]) - _c_div2(prev2[s - 2])
                d = (int(img[row, s]) - pred) % 65536
                if d > 32767:
                    d -= 65536
                cur[s] = pred + d
                diffs.append(d)
            # Stream order matches decode: both length CODES first,
            # then both difference fields.
            lens = [_diff_len(d) for d in diffs]
            for ln in lens:
                cl, code = _ENC_CODES[ln]
                bw.put(cl, code)
            for d, ln in zip(diffs, lens):
                if ln:
                    bw.put(ln, d if d > 0 else d + (1 << ln) - 1)
    return bytes(head) + bw.flush()
