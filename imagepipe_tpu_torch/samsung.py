"""Samsung SRW 12-bit compressed raw (TIFF compression 32772, NX bodies).

The reference chain covers Samsung NX raws through rawloader
(the reference's src/pipeline.rs:264; rawloader's srw module implements
the same per-row scheme dcraw's samsung_load_raw pins down). Layout, per
row of the sensor:

  * a u32 little-endian PER-ROW OFFSET table locates each row's
    bitstream (dcraw seeks strip_offset+row*4, reads the offset, then
    reads the row at data_offset+offset with a fresh Phase-One-style
    bit reader: little-endian 32-bit words, bits MSB-first per word —
    the same reader as Phase One IIQ, shared from iiq.py);
  * each row is coded in blocks of 16 pixels: 1 direction bit (0 =
    horizontal prediction, 1 = vertical), then four 2-bit length ops
    (0 keep, 1 increment, 2 decrement, 3 reload from 4 bits) updating
    four running difference bit-lengths, then 16 sign-extended diffs —
    EVEN pixels first (c = 0,2,..,14), then ODD (c = 1,3,..,15), the
    even pixels of each half-block using len[0]/len[1] and the odd ones
    len[2]/len[3] (index ((c&1)<<1) | (c>>3));
  * prediction: vertical = two rows up for even pixels, one row up for
    odd (row + (c&1) - 2); horizontal = same-parity left neighbor
    (col+c-2), with the row's FIRST 16-block predicting the constant
    128 (the `col ? RAW(row,col+c-2) : 128` ternary — the whole first
    block, not just the first pixel);
  * lengths re-initialize per row: 7 for the first two rows, 4 after;
  * after all rows, a checkerboard unscramble swaps RAW(row,col+1)
    with RAW(row+1,col) on every even (row,col) pair.

PROVENANCE: the block structure, the ((c&1)<<1)|(c>>3) length indexing,
the (c&1)-2 vertical offsets, the 7/4 length init, the first-block-128
rule and the final swap are recalled dcraw semantics implemented from
memory and pinned mechanically by encode/decode round-trips; the
first-real-NX-file run of the realfile harness (tests/test_realfiles.py)
is the confirmation gate, exactly like fujic.py's B2 mask and
vendor.py's _SRAW_RGB constants. A desync would show as gross garbage,
not subtle tint: every constant here shifts the bitstream framing.
"""

from __future__ import annotations

import struct

import numpy as np

from .iiq import _Ph1Bits, _Ph1BitsWriter

__all__ = ["decode_samsung12", "encode_samsung12"]


def _decode_native(data: bytes, width: int, height: int) -> np.ndarray:
    import ctypes

    from . import native

    fn = native._lib.samsung12_decode
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_int, ctypes.POINTER(ctypes.c_uint16)]
    out = np.empty((height, width), np.uint16)
    rc = fn(data, len(data), width, height,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
    if rc != 0:
        raise ValueError(f"SRW 32772: corrupt compressed stream (rc={rc})")
    return out


def _len_index(c: int) -> int:
    return ((c & 1) << 1) | (c >> 3)


def decode_samsung12(data: bytes, width: int, height: int,
                     table_pos: int = 0, data_pos: int | None = None
                     ) -> np.ndarray:
    """Decode a compression-32772 payload. `table_pos` locates the u32
    per-row offset table inside `data`; row offsets are relative to
    `data_pos` (default: end of the table, the canonical layout).
    Dispatches to the native twin (native/samsung.cc) when built; the
    Python body below is the reference implementation the differential
    fuzz pins it to."""
    from . import native

    if (table_pos == 0 and data_pos is None and native.have_native()
            and hasattr(native._lib, "samsung12_decode")):
        return _decode_native(bytes(data), width, height)
    return _decode_python(data, width, height, table_pos, data_pos)


def _decode_python(data: bytes, width: int, height: int,
                   table_pos: int = 0, data_pos: int | None = None
                   ) -> np.ndarray:
    if width % 32 or width <= 0 or height % 2 or height <= 0:
        # 16-pixel blocks plus the 2x2 unscramble; real NX geometries comply.
        raise ValueError(
            f"SRW 32772: unsupported geometry {width}x{height} "
            "(need width%32==0, even height)")
    if data_pos is None:
        data_pos = table_pos + 4 * height
    if table_pos + 4 * height > len(data):
        raise ValueError("SRW 32772: offset table out of range")
    offsets = np.frombuffer(data, "<u4", height, table_pos)
    out = np.zeros((height, width), np.int32)
    for row in range(height):
        off = data_pos + int(offsets[row])
        if not 0 <= off <= len(data):
            raise ValueError("SRW 32772: row offset out of range")
        bits = _Ph1Bits(data, off, "<")
        ln = [7, 7, 7, 7] if row < 2 else [4, 4, 4, 4]
        for col in range(0, width, 16):
            direction = bits(1)
            if direction and row < 2:
                raise ValueError(
                    "SRW 32772: vertical prediction on the first rows")
            for c in range(4):
                op = bits(2)
                if op == 3:
                    ln[c] = bits(4)
                elif op == 2:
                    ln[c] -= 1
                elif op == 1:
                    ln[c] += 1
                if not 0 <= ln[c] <= 14:
                    raise ValueError(f"SRW 32772: length {ln[c]} out of range")
            c = 0
            while True:
                i = ln[_len_index(c)]
                v = bits(i)
                if i and v >= (1 << (i - 1)):
                    v -= (1 << i)                  # sign-extend i bits
                if direction:
                    pred = int(out[row + (c & 1) - 2, col + c])
                else:
                    pred = int(out[row, col + c - 2]) if col else 128
                out[row, col + c] = pred + v
                if c == 14:
                    c = 1
                elif c == 15:
                    break
                else:
                    c += 2
    if (out < 0).any() or (out > 0xFFFF).any():
        raise ValueError("SRW 32772: decoded sample out of u16 range")
    out = out.astype(np.uint16)
    # Checkerboard unscramble (dcraw's trailing swap loop).
    a = out[0::2, 1::2].copy()
    out[0::2, 1::2] = out[1::2, 0::2]
    out[1::2, 0::2] = a
    return out


def encode_samsung12(img: np.ndarray) -> bytes:
    """Canonical encoder (tests/fixtures): exact inverse of
    decode_samsung12, emitting [u32 offset table][row bitstreams]."""
    img = np.asarray(img, np.uint16)
    height, width = img.shape
    if width % 32 or height % 2:
        raise ValueError("SRW 32772 encoder: width%32==0, even height")
    # Inverse checkerboard scramble first.
    raw = img.astype(np.int32).copy()
    a = raw[0::2, 1::2].copy()
    raw[0::2, 1::2] = raw[1::2, 0::2]
    raw[1::2, 0::2] = a

    def nbits(d: int) -> int:
        # smallest i with d representable as signed i bits (i=0 -> d==0)
        i = 0
        while not (-(1 << i) >> 1 <= d <= ((1 << i) >> 1) - 1 if i else d == 0):
            i += 1
            if i > 14:
                raise ValueError("SRW 32772 encoder: diff needs >14 bits")
        return i

    rows_payload = []
    for row in range(height):
        bw = _Ph1BitsWriter("<")
        ln = [7, 7, 7, 7] if row < 2 else [4, 4, 4, 4]
        for col in range(0, width, 16):
            # candidate diffs per direction
            cand = {}
            for direction in (0, 1):
                if direction and row < 2:
                    continue
                diffs = []
                ok = True
                for c in list(range(0, 16, 2)) + list(range(1, 16, 2)):
                    if direction:
                        pred = int(raw[row + (c & 1) - 2, col + c])
                    else:
                        pred = int(raw[row, col + c - 2]) if col else 128
                    d = int(raw[row, col + c]) - pred
                    if not -(1 << 13) <= d < (1 << 13):
                        ok = False
                        break
                    diffs.append((c, d))
                if ok:
                    cand[direction] = diffs
            if not cand:
                raise ValueError("SRW 32772 encoder: block not codable")
            # pick the direction with the smaller total magnitude
            direction = min(cand, key=lambda k: sum(abs(d) for _, d in cand[k]))
            diffs = cand[direction]
            need = [0, 0, 0, 0]
            for c, d in diffs:
                need[_len_index(c)] = max(need[_len_index(c)], nbits(d))
            bw.put(1, direction)
            ops = []
            for g in range(4):
                if need[g] == ln[g]:
                    ops.append((0, None))
                elif need[g] == ln[g] + 1:
                    ops.append((1, None))
                    ln[g] += 1
                elif need[g] == ln[g] - 1:
                    ops.append((2, None))
                    ln[g] -= 1
                else:
                    ops.append((3, need[g]))
                    ln[g] = need[g]
            for op, arg in ops:
                bw.put(2, op)
                if op == 3:
                    bw.put(4, arg)
            for c, d in diffs:
                i = ln[_len_index(c)]
                bw.put(i, d & ((1 << i) - 1))
        rows_payload.append(bw.row_bytes())
    table = bytearray()
    pos = 0
    for rb in rows_payload:
        table += struct.pack("<I", pos)
        pos += len(rb)
    return bytes(table) + b"".join(rows_payload)
