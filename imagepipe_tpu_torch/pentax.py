"""Pentax PEF compressed codec (the Huffman-coded predictive bitstream).

Every compressed PEF (Compression tag 65535) since the *ist D writes this
stream; the reference reaches it through rawloader at
the reference's src/pipeline.rs:264. The scheme is fixed and public --
this implementation follows the widely-documented dcraw
`pentax_load_raw` semantics, which RawSpeed's PentaxDecompressor and
rawloader's PEF decoder also mirror:

  * the Huffman table ships in Pentax maker-note tag 0x0220: a u16 whose
    value +12 (mod 16) is the symbol count, 12 filler bytes, then per
    symbol a u16 "bit position" (the 12-bit window start: the code prefix
    left-aligned in 12 bits) and a u8 code length; bodies without the
    tag (the *ist D generation) use a fixed default tree (the public
    `pentax_tree` table);
  * the payload is a plain MSB-first bitstream (no marker stuffing);
    each pixel decodes a Huffman symbol c (the JPEG difference
    category), then c mantissa bits, sign-extended JPEG-style
    (category 0 -> 0, category 16 -> -32768 without mantissa);
  * prediction: the first two columns of each row add the difference to
    a per-(row-parity, column) vertical predictor (i.e. predict from two
    rows up); every other pixel predicts from two columns left, per
    column parity. Predictors wrap at 16 bits like dcraw's `ushort`.

The decoder prefers the native C++ implementation (native/pentax.cc, via
ctypes) and falls back to pure Python; the encoder exists for tests: it
emits canonical streams so round-trips pin every mechanism (both
predictors, all categories, the table parse). Real-file cross-validation
(tests/test_realfiles.py) is the external check, exactly as for the
Nikon 34713 and Olympus codecs.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from . import native

__all__ = ["PentaxHuff", "decode_pentax", "encode_pentax"]

# The public default tree (dcraw/RawSpeed `pentax_tree`) used by bodies
# whose maker note carries no 0x0220 table: counts-per-code-length
# (lengths 1..16) and the symbols in canonical order.
_DEFAULT_COUNTS = (0, 2, 3, 1, 1, 1, 1, 1, 1, 2, 0, 0, 0, 0, 0, 0)
_DEFAULT_SYMBOLS = (3, 4, 2, 5, 1, 6, 0, 7, 8, 9, 10, 11, 12)


class PentaxHuff:
    """A parsed Pentax Huffman table: (symbol, length, prefix) triples
    plus the 4096-entry 12-bit-window lookup (value `len<<8 | symbol`)."""

    def __init__(self, triples: list[tuple[int, int, int]]):
        self.triples = list(triples)
        table = np.zeros(4096, np.uint16)
        hit = np.zeros(4096, bool)
        for sym, length, prefix in self.triples:
            if not 1 <= length <= 12:
                raise ValueError(f"pentax huff: code length {length} "
                                 "outside 1..12")
            if not 0 <= sym <= 16:
                raise ValueError(f"pentax huff: difference category {sym} "
                                 "outside 0..16")
            if prefix >> length:
                raise ValueError("pentax huff: prefix wider than its length")
            span = 4096 >> length
            start = prefix << (12 - length)
            table[start:start + span] = (length << 8) | sym
            hit[start:start + span] = True
        # A valid table covers every 12-bit window exactly once (the
        # Kraft sum is 1); dcraw's last-wins overwrite on overlap would
        # silently corrupt decodes, so refuse ambiguous/incomplete specs.
        if sum(4096 >> length for _, length, _ in self.triples) != 4096 \
                or not hit.all():
            raise ValueError("pentax huff: table does not cover the "
                             "12-bit window exactly (corrupt spec)")
        self.table = table
        self.by_symbol = {sym: (length, prefix)
                          for sym, length, prefix in self.triples}
        if len(self.by_symbol) != len(self.triples):
            raise ValueError("pentax huff: duplicate difference category")

    @classmethod
    def from_spec(cls, blob: bytes, endian: str = ">") -> "PentaxHuff":
        """Parse a maker-note tag 0x0220 payload (`endian` is the maker
        note's byte order)."""
        if len(blob) < 14:
            raise ValueError("pentax huff: spec shorter than its header")
        (v,) = struct.unpack_from(endian + "H", blob, 0)
        dep = (v + 12) & 15
        if dep == 0:
            raise ValueError("pentax huff: zero symbols")
        need = 14 + dep * 3
        if len(blob) < need:
            raise ValueError("pentax huff: spec truncated")
        bit0 = struct.unpack_from(endian + f"{dep}H", blob, 14)
        lens = struct.unpack_from(f"{dep}B", blob, 14 + dep * 2)
        triples = []
        for c in range(dep):
            length = lens[c]
            if not 1 <= length <= 12:
                raise ValueError(f"pentax huff: code length {length} "
                                 "outside 1..12")
            if bit0[c] & ((1 << (12 - length)) - 1):
                raise ValueError("pentax huff: bit position not aligned "
                                 "to its code length")
            triples.append((c, length, bit0[c] >> (12 - length)))
        return cls(triples)

    @classmethod
    def default(cls) -> "PentaxHuff":
        """The fixed default tree for table-less bodies."""
        triples = []
        code = 0
        sym_it = iter(_DEFAULT_SYMBOLS)
        for length, count in enumerate(_DEFAULT_COUNTS, start=1):
            for _ in range(count):
                triples.append((next(sym_it), length, code))
                code += 1
            code <<= 1
        return cls(triples)

    @classmethod
    def uniform(cls, nsyms: int) -> "PentaxHuff":
        """A complete canonical tree over `nsyms` categories 0..nsyms-1
        (test/tooling aid for synthesizing specs)."""
        if not 2 <= nsyms <= 15:
            raise ValueError("pentax spec holds 2..15 symbols")
        depth = (nsyms - 1).bit_length()
        shallow = (1 << depth) - nsyms  # leaves promoted one level up
        lengths = [depth - 1] * shallow + [depth] * (nsyms - shallow)
        triples = []
        code = 0
        prev_len = lengths[0]
        for sym, length in enumerate(lengths):
            code <<= (length - prev_len)
            prev_len = length
            triples.append((sym, length, code))
            code += 1
        return cls(triples)

    def to_spec(self, endian: str = ">") -> bytes:
        """Serialize as a maker-note tag 0x0220 payload. The stream format
        indexes categories by table position, so the symbols must be
        exactly 0..n-1 (they are, for every real table)."""
        dep = len(self.triples)
        ordered = sorted(self.triples)
        if [s for s, _, _ in ordered] != list(range(dep)):
            raise ValueError("pentax spec requires contiguous categories "
                             "0..n-1")
        out = struct.pack(endian + "H", (dep - 12) % 16) + b"\0" * 12
        for _, length, prefix in ordered:
            out += struct.pack(endian + "H", prefix << (12 - length))
        for _, length, _ in ordered:
            out += struct.pack("B", length)
        return out


def _extend(mant: int, c: int) -> int:
    """JPEG difference sign extension for category c."""
    if c == 0:
        return 0
    if c == 16:
        return -32768
    if mant & (1 << (c - 1)):
        return mant
    return mant - (1 << c) + 1


def _decode_python(payload: bytes, width: int, height: int,
                   huff: PentaxHuff) -> np.ndarray:
    data = payload
    nbits_total = len(data) * 8
    pos = 0
    table = huff.table

    def peek12() -> int:
        byte = pos >> 3
        chunk = data[byte:byte + 3]
        acc = int.from_bytes(chunk + b"\0" * (3 - len(chunk)), "big")
        return (acc >> (24 - 12 - (pos & 7))) & 0xFFF

    def get(n: int) -> int:
        nonlocal pos
        if n == 0:
            return 0
        if pos + n > nbits_total:
            raise ValueError("PEF compressed: bitstream exhausted")
        v = 0
        for _ in range(n):
            v = (v << 1) | ((data[pos >> 3] >> (7 - (pos & 7))) & 1)
            pos += 1
        return v

    out = np.zeros((height, width), np.uint16)
    vpred = [[0, 0], [0, 0]]
    for row in range(height):
        hpred = [0, 0]
        for col in range(width):
            ent = int(table[peek12()])
            length = ent >> 8
            if length == 0 or pos + length > nbits_total:
                raise ValueError("PEF compressed: bitstream exhausted")
            pos += length
            c = ent & 0xFF
            diff = _extend(get(c) if c not in (0, 16) else 0, c)
            if col < 2:
                vpred[row & 1][col] = (vpred[row & 1][col] + diff) & 0xFFFF
                hpred[col] = vpred[row & 1][col]
            else:
                hpred[col & 1] = (hpred[col & 1] + diff) & 0xFFFF
            out[row, col] = hpred[col & 1]
    return out


def _decode_native(payload: bytes, width: int, height: int,
                   huff: PentaxHuff) -> np.ndarray:
    lib = native._lib
    fn = lib.pentax_decode
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_uint16),
                   ctypes.POINTER(ctypes.c_uint16)]
    out = np.empty((height, width), np.uint16)
    table = np.ascontiguousarray(huff.table)
    rc = fn(payload, len(payload), width, height,
            table.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
    if rc != 0:
        raise ValueError("PEF compressed: bitstream exhausted")
    return out


def decode_pentax(payload: bytes, width: int, height: int,
                  huff: PentaxHuff | None = None) -> np.ndarray:
    """Decode a Pentax-compressed strip to a (height, width) u16 sensor
    plane. `huff` defaults to the fixed table-less-body tree. Raises
    ValueError on truncated/corrupt streams."""
    payload = bytes(payload)
    huff = huff or PentaxHuff.default()
    if native.have_native() and hasattr(native._lib, "pentax_decode"):
        return _decode_native(payload, width, height, huff)
    return _decode_python(payload, width, height, huff)


def encode_pentax(img: np.ndarray, huff: PentaxHuff | None = None) -> bytes:
    """Encode a u16 sensor plane as a canonical Pentax-compressed stream
    (test/tooling aid: decode(encode(x)) == x through either decoder).
    Every difference's category must exist in the table."""
    img = np.asarray(img)
    if img.ndim != 2:
        raise ValueError("expected a 2-D sensor plane")
    huff = huff or PentaxHuff.default()
    height, width = img.shape
    bits_out = bytearray()
    acc = 0
    nacc = 0

    def put(n: int, v: int) -> None:
        nonlocal acc, nacc
        if n == 0:
            return
        acc = (acc << n) | (v & ((1 << n) - 1))
        nacc += n
        while nacc >= 8:
            nacc -= 8
            bits_out.append((acc >> nacc) & 0xFF)
        acc &= (1 << nacc) - 1

    vpred = [[0, 0], [0, 0]]
    for row in range(height):
        hpred = [0, 0]
        for col in range(width):
            val = int(img[row, col])
            if not 0 <= val <= 0xFFFF:
                raise ValueError("pixel out of u16 range")
            pred = (vpred[row & 1][col] if col < 2 else hpred[col & 1])
            # The decoder wraps at 16 bits, so any difference has an
            # equivalent representative in [-32768, 32767].
            diff = ((val - pred + 0x8000) & 0xFFFF) - 0x8000
            c = 0 if diff == 0 else abs(diff).bit_length()
            if diff == -32768:
                c = 16
            if c not in huff.by_symbol:
                raise ValueError(f"difference category {c} not in the "
                                 "Huffman table")
            length, prefix = huff.by_symbol[c]
            put(length, prefix)
            if c not in (0, 16):
                put(c, diff if diff > 0 else diff + (1 << c) - 1)
            if col < 2:
                vpred[row & 1][col] = (vpred[row & 1][col] + diff) & 0xFFFF
                hpred[col] = vpred[row & 1][col]
            else:
                hpred[col & 1] = (hpred[col & 1] + diff) & 0xFFFF
            if hpred[col & 1] != val:
                raise AssertionError("encoder self-check failed")
    if nacc:
        put(8 - nacc, 0)
    return bytes(bits_out)
