"""Sony ARW v1 (DSLR-A100) compressed raw.

The reference chain reaches the A100 through rawloader
(the reference's src/pipeline.rs:264); the scheme is the one dcraw's
sony_arw_load_raw pins down — a single Huffman-coded DPCM chain over a
COLUMN-MAJOR, parity-striped traversal:

  * columns run RIGHT to LEFT; within a column all EVEN rows decode
    top-to-bottom, then all ODD rows (dcraw's `row == raw_height →
    row = 1` wrap; even sensor height required — the wrap never fires
    for odd heights and dcraw would skip the odd rows);
  * ONE running sum carries across the entire traversal (never reset
    per column): each step adds a lossless-JPEG-style diff and stores
    the 12-bit running value;
  * diffs use a FIXED Huffman table (no tables in the file) mapping a
    code to the diff bit-length, then that many raw bits, sign-mapped
    the standard ljpeg way (top bit clear → v - (2^len - 1)); length
    16 is the bare -32768 escape, length 17 reads 17 literal bits;
  * bits are MSB-first per byte, one continuous stream.

The fixed code table is dcraw's 18-entry `tab`, each entry
(code_length << 8) | diff_length, assigned lookahead slots in order —
its Kraft sum telescopes to exactly 1.0 (a complete prefix code),
which independently corroborates the recalled constants:

    0xf11 0xf10 0xe0f 0xd0e 0xc0d 0xb0c 0xa0b 0x90a 0x809
    0x708 0x607 0x506 0x405 0x304 0x303 0x300 0x202 0x201

PROVENANCE: recalled dcraw semantics implemented from memory, pinned
mechanically by encode/decode round-trips + the Kraft identity; the
first real A100 file through the realfile harness
(tests/test_realfiles.py) is the confirmation gate (`arw-v1` row). A
desync shifts the bitstream framing and shows as gross garbage.
"""

from __future__ import annotations

import numpy as np

__all__ = ["decode_arw1", "encode_arw1"]

_TAB = (0xF11, 0xF10, 0xE0F, 0xD0E, 0xC0D, 0xB0C, 0xA0B, 0x90A, 0x809,
        0x708, 0x607, 0x506, 0x405, 0x304, 0x303, 0x300, 0x202, 0x201)
_PEEK = 15


def _code_table():
    """entry list [(code_length, code_bits, diff_length)] from the slot
    assignment (entry k's code = its first lookahead slot >> (15-len))."""
    out = []
    slot = 0
    for e in _TAB:
        clen, val = e >> 8, e & 0xFF
        out.append((clen, slot >> (_PEEK - clen), val))
        slot += 1 << (_PEEK - clen)
    if slot != 1 << _PEEK:
        raise AssertionError("ARW1 code table is not complete")
    return out


def decode_arw1(data: bytes, width: int, height: int) -> np.ndarray:
    """Decode an ARW1 strip. Dispatches to the native twin
    (native/arw1.cc) when built; the Python body below is the reference
    implementation the differential fuzz pins it to."""
    from . import native

    if native.have_native() and hasattr(native._lib, "arw1_decode"):
        return _decode_native(bytes(data), width, height)
    return _decode_python(data, width, height)


def _decode_native(data: bytes, width: int, height: int) -> np.ndarray:
    import ctypes

    from . import native

    fn = native._lib.arw1_decode
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_int, ctypes.POINTER(ctypes.c_uint16)]
    out = np.empty((height, width), np.uint16)
    rc = fn(data, len(data), width, height,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
    if rc != 0:
        raise ValueError(f"ARW1: corrupt compressed stream (rc={rc})")
    return out


def _row_order(height: int):
    return list(range(0, height, 2)) + list(range(1, height, 2))


def _decode_python(data: bytes, width: int, height: int) -> np.ndarray:
    if width <= 0 or height <= 0 or height % 2:
        raise ValueError(f"ARW1: unsupported geometry {width}x{height} "
                         "(even height required)")
    # peek-table: 15-bit lookahead -> (code_length, diff_length)
    peek = np.zeros(1 << _PEEK, np.uint16)
    slot = 0
    for e in _TAB:
        n = 1 << (_PEEK - (e >> 8))
        peek[slot:slot + n] = e
        slot += n
    nbits = 8 * len(data)
    out = np.zeros((height, width), np.uint16)
    pos = 0
    total = 0
    rows = _row_order(height)

    def bits_at(p: int, n: int) -> int:
        # MSB-first read of n bits at bit position p, zero-padded past
        # the end (padding may be PEEKED, never consumed).
        v = 0
        for k in range(n):
            q = p + k
            v = (v << 1) | ((data[q >> 3] >> (7 - (q & 7))) & 1
                            if q < nbits else 0)
        return v

    for col in range(width - 1, -1, -1):
        for row in rows:
            e = int(peek[bits_at(pos, _PEEK)])
            clen, dlen = e >> 8, e & 0xFF
            pos += clen
            if dlen == 16:
                diff = -32768
            elif dlen == 0:
                diff = 0
            else:
                v = bits_at(pos, dlen)
                pos += dlen
                diff = v if v & (1 << (dlen - 1)) else v - ((1 << dlen) - 1)
            if pos > nbits:
                raise ValueError("ARW1: bitstream truncated")
            total += diff
            if not 0 <= total <= 0xFFF:
                raise ValueError("ARW1: running sum out of 12-bit range")
            out[row, col] = total
    return out


def encode_arw1(img: np.ndarray) -> bytes:
    """Canonical encoder (tests/fixtures): exact inverse of decode_arw1."""
    img = np.asarray(img, np.uint16)
    height, width = img.shape
    if height % 2:
        raise ValueError("ARW1 encoder: even height required")
    if img.max(initial=0) > 0xFFF:
        raise ValueError("ARW1 encoder: 12-bit samples only")
    enc = {val: (clen, code) for clen, code, val in _code_table()}
    rows = _row_order(height)
    acc = 0
    nacc = 0
    out = bytearray()
    total = 0
    for col in range(width - 1, -1, -1):
        for row in rows:
            d = int(img[row, col]) - total
            total = int(img[row, col])
            dlen = max(d.bit_length(), (-d).bit_length())
            if dlen > 12:
                raise AssertionError("12-bit data cannot need len > 12")
            clen, code = enc[dlen]
            acc = (acc << clen) | code
            nacc += clen
            if dlen:
                v = d if d > 0 else d + (1 << dlen) - 1
                acc = (acc << dlen) | v
                nacc += dlen
            while nacc >= 8:
                nacc -= 8
                out.append((acc >> nacc) & 0xFF)
            acc &= (1 << nacc) - 1
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)
