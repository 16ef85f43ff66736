"""Kodak DCR/KDC compressed raw (TIFF compression 65000, DCS Pro /
P-series bodies).

The reference chain covers Kodak raws through rawloader
(the reference's src/pipeline.rs:264); the per-run scheme is the one
dcraw's kodak_65000_load_raw / kodak_65000_decode pin down. The strip
is one sequential stream of independent RUNS, row-major, each run
covering min(256, width-col) pixels of one row:

  * per run, two interleaved predictors (even/odd columns — the two
    CFA colors of the row) reset to 0;
  * the run starts with a 4-bit LENGTH NIBBLE per pixel, two per byte
    (low nibble first), the pixel count rounded UP to a multiple of 4
    (padding lengths are written 0 by the canonical encoder but still
    consume their declared bits if nonzero);
  * then the diff bits: a flat sequence of BIG-endian 16-bit words
    consumed LSB-first from an accumulating buffer — dcraw seeds 16
    bits up front when the rounded count % 8 == 4, then refills 32
    bits (two words) whenever short; refill timing only changes WHEN
    words are fetched, never their order, but it DOES size the run:
    whole fetched words are discarded at run end, so the encoder pads
    to the exact fetch boundary the reader will hit;
  * a diff of declared length L recovers as: v if the top bit
    (1<<(L-1)) is set, else v - ((1<<L)-1) — i.e. L covers
    [-(2^L - 1), -(2^(L-1))] u [2^(L-1), 2^L - 1], L=0 means 0;
  * any length nibble > 12 flags the WHOLE run as stored uncompressed
    instead: re-read from the run start as groups of six u16 (file
    endianness) per eight pixels — the six low 12-bit fields are
    pixels 2..7 and the six TOP nibbles assemble pixels 0 and 1
    ((w0>>12)<<8 | (w2>>12)<<4 | (w4>>12), same for odd words); these
    values are absolute, not predicted.

Values are 12-bit after the per-file linearization curve; this module
decodes the raw code stream (identity curve — real DCR linearization
tags are not interpreted, documented gap).

PROVENANCE: the run framing, nibble packing, word order/LSB-first
consumption, the %8==4 pre-seed, the negative-diff mapping, and the
6-words-to-8-pixels uncompressed fallback are recalled dcraw semantics
implemented from memory and pinned mechanically by encode/decode
round-trips; the first real DCR/KDC through the realfile harness
(tests/test_realfiles.py) is the confirmation gate, exactly like
samsung.py. A desync shifts the bitstream framing and shows as gross
garbage, not subtle tint.
"""

from __future__ import annotations

import numpy as np

__all__ = ["decode_kodak65000", "encode_kodak65000"]

_RUN = 256
_MAX_LEN = 12


def decode_kodak65000(data: bytes, width: int, height: int) -> np.ndarray:
    """Decode a compression-65000 strip. Dispatches to the native twin
    (native/kodak.cc) when built; the Python body below is the
    reference implementation the differential fuzz pins it to."""
    from . import native

    if native.have_native() and hasattr(native._lib, "kodak65000_decode"):
        return _decode_native(bytes(data), width, height)
    return _decode_python(data, width, height)


def _decode_native(data: bytes, width: int, height: int) -> np.ndarray:
    import ctypes

    from . import native

    fn = native._lib.kodak65000_decode
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_int, ctypes.POINTER(ctypes.c_uint16)]
    out = np.empty((height, width), np.uint16)
    rc = fn(data, len(data), width, height,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
    if rc != 0:
        raise ValueError(f"KDC/DCR 65000: corrupt stream (rc={rc})")
    return out


class _Reader:
    """dcraw's per-run bit state: BE u16 words, LSB-first consumption,
    32-bit refills (16-bit pre-seed handled by the caller)."""

    def __init__(self, data: bytes, pos: int):
        self.data = data
        self.pos = pos
        self.buf = 0
        self.bits = 0

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise ValueError("KDC/DCR 65000: stream truncated")
        b = self.data[self.pos]
        self.pos += 1
        return b

    def seed16(self):
        self.buf = (self.byte() << 8) | self.byte()
        self.bits = 16

    def take(self, length: int) -> int:
        if self.bits < length:
            for j in (8, 0, 24, 16):            # dcraw's (j ^ 8) refill
                self.buf += self.byte() << (self.bits + j)
            self.bits += 32
        v = self.buf & ((1 << length) - 1)
        self.buf >>= length
        self.bits -= length
        return v


def _decode_python(data: bytes, width: int, height: int) -> np.ndarray:
    if width <= 0 or height <= 0:
        raise ValueError(f"KDC/DCR 65000: bad geometry {width}x{height}")
    out = np.zeros((height, width), np.uint16)
    pos = 0
    for row in range(height):
        for col in range(0, width, _RUN):
            n = min(_RUN, width - col)
            rounded = (n + 3) & ~3
            start = pos
            lens = []
            for _ in range(rounded // 2):
                if pos >= len(data):
                    raise ValueError("KDC/DCR 65000: stream truncated")
                b = data[pos]
                pos += 1
                lens.append(b & 15)
                lens.append(b >> 4)
            if max(lens) > _MAX_LEN:
                # Uncompressed run: re-read from the run start as six
                # u16 LE per eight pixels.
                groups = (rounded + 7) // 8
                need = 12 * groups
                if start + need > len(data):
                    raise ValueError("KDC/DCR 65000: stream truncated")
                w = np.frombuffer(data, "<u2", 6 * groups, start)
                vals = []
                for g in range(groups):
                    r = w[6 * g:6 * g + 6].astype(np.int64)
                    vals.append((r[0] >> 12 << 8) | (r[2] >> 12 << 4)
                                | (r[4] >> 12))
                    vals.append((r[1] >> 12 << 8) | (r[3] >> 12 << 4)
                                | (r[5] >> 12))
                    vals.extend(int(x) & 0xFFF for x in r)
                pos = start + need
                out[row, col:col + n] = vals[:n]
                continue
            rd = _Reader(data, pos)
            if rounded & 7 == 4:
                rd.seed16()
            vals = []
            for length in lens:
                if length == 0:
                    vals.append(0)
                    continue
                v = rd.take(length)
                if not v & (1 << (length - 1)):
                    v -= (1 << length) - 1
                vals.append(v)
            pos = rd.pos
            pred = [0, 0]
            for i in range(n):
                pred[i & 1] += vals[i]
                if not 0 <= pred[i & 1] <= 0xFFF:
                    raise ValueError(
                        "KDC/DCR 65000: decoded sample out of 12-bit range")
                out[row, col + i] = pred[i & 1]
    return out


def encode_kodak65000(img: np.ndarray,
                      uncompressed_runs: set | None = None) -> bytes:
    """Canonical encoder (tests/fixtures): exact inverse of
    decode_kodak65000. `uncompressed_runs` optionally names (row, col)
    run origins to store via the 6-words-per-8-pixels absolute form
    (exercises the fallback)."""
    img = np.asarray(img, np.uint16)
    if img.max(initial=0) > 0xFFF:
        raise ValueError("KDC/DCR 65000 encoder: 12-bit samples only")
    height, width = img.shape
    uncompressed_runs = uncompressed_runs or set()
    out = bytearray()
    for row in range(height):
        for col in range(0, width, _RUN):
            n = min(_RUN, width - col)
            rounded = (n + 3) & ~3
            px = img[row, col:col + n].astype(np.int64)
            if (row, col) in uncompressed_runs:
                groups = (rounded + 7) // 8
                vals = [0] * (8 * groups)
                vals[:n] = (int(v) for v in px)
                words = [0] * (6 * groups)
                for g in range(groups):
                    for j in range(6):
                        words[6 * g + j] = vals[8 * g + 2 + j] & 0xFFF
                    a, b = vals[8 * g], vals[8 * g + 1]
                    for k, (va, vb) in enumerate((
                            (a >> 8, b >> 8), (a >> 4, b >> 4), (a, b))):
                        words[6 * g + 2 * k] |= (va & 0xF) << 12
                        words[6 * g + 2 * k + 1] |= (vb & 0xF) << 12
                head = np.asarray(words, "<u2").tobytes()
                # There is no length-nibble prefix in this form: the
                # reader flags it by finding a nibble > 12 within the
                # first rounded/2 bytes and re-reads from the run START.
                # dcraw only enters this path when a real file wrote
                # such data, so the canonical form requires the flag to
                # hold by construction.
                scan = head[:rounded // 2]
                if all((b & 15) <= _MAX_LEN and (b >> 4) <= _MAX_LEN
                       for b in scan):
                    raise ValueError(
                        "KDC/DCR 65000 encoder: run data does not flag "
                        "the uncompressed form (no nibble > 12 in the "
                        "scan span); adjust the fixture")
                out += head
                continue
            pred = [0, 0]
            lens = []
            encoded = []
            for i in range(n):
                d = int(px[i]) - pred[i & 1]
                pred[i & 1] = int(px[i])
                if d == 0:
                    lens.append(0)
                    continue
                length = max(d.bit_length(), (-d).bit_length())
                if length > _MAX_LEN:
                    raise ValueError(
                        "KDC/DCR 65000 encoder: diff needs >12 bits")
                lens.append(length)
                encoded.append((d if d > 0 else d + (1 << length) - 1,
                                length))
            lens += [0] * (rounded - n)
            for i in range(0, rounded, 2):
                out.append(lens[i] | (lens[i + 1] << 4))
            # Materialize the bit payload with the reader's fetch
            # pattern: optional 16-bit pre-seed, then 32-bit refills.
            bits_avail = 16 if rounded & 7 == 4 else 0
            capacity = bits_avail
            for _, length in encoded:
                if bits_avail < length:
                    bits_avail += 32
                    capacity += 32
                bits_avail -= length
            stream = 0
            at = 0
            for v, length in encoded:
                stream |= v << at
                at += length
            nwords = capacity // 16
            for w in range(nwords):
                chunk = (stream >> (16 * w)) & 0xFFFF
                out += bytes(((chunk >> 8) & 0xFF, chunk & 0xFF))
    return bytes(out)
