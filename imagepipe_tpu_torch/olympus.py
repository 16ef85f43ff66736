"""Olympus ORF compressed codec (the 12-bit predictive bitstream).

Every Olympus body since ~2004 writes this stream in its compressed ORFs
(the reference reaches it through rawloader at
the reference's src/pipeline.rs:264). The scheme is fixed and public --
this implementation follows the widely-documented dcraw
`olympus_load_raw` semantics, which rawloader's ORF decoder also mirrors:

  * the payload starts with a 7-byte preamble, then a plain MSB-first
    bitstream (no marker stuffing);
  * per pixel: 3 raw bits (sign + 2 low bits), a unary-coded magnitude
    class `high` (v zeros then a 1 for v<=11; 12 zeros escapes to an
    explicit `16-nbits`-bit field whose LSB is dropped), then `nbits`
    mantissa bits -- `nbits` adapts per column parity from the previous
    magnitude via a small carry state (acarry[2][3]);
  * the reconstructed residual is `((high<<nbits | mantissa) ^ sign) +
    carry1`, scaled by 4 and merged with the 2 low bits;
  * the spatial predictor is 0 / left-left / up-up on the first two
    rows/columns and otherwise a gradient-medium of the same-parity
    W/N/NW neighbors (average when NW is between W and N and both
    gradients are small, plane-fit when between but steep, else the
    neighbor across the smaller gradient).

The decoder prefers the native C++ implementation (native/olympus.cc,
via ctypes) and falls back to pure Python; the encoder exists for tests:
it emits canonical streams (unary class + exact mantissa) so round-trips
pin every mechanism, including the escape path. Real-file
cross-validation (tests/test_realfiles.py) is the external check on the
predictor/carry details, exactly as for the Nikon 34713 codec.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import native

__all__ = ["decode_olympus", "encode_olympus"]

_PREAMBLE = 7  # bytes skipped before the bitstream starts


def _predict(out: np.ndarray, row: int, col: int) -> int:
    """dcraw's olympus gradient predictor over same-parity neighbors."""
    if row < 2 and col < 2:
        return 0
    if row < 2:
        return int(out[row, col - 2])
    if col < 2:
        return int(out[row - 2, col])
    w = int(out[row, col - 2])
    n = int(out[row - 2, col])
    nw = int(out[row - 2, col - 2])
    if (w < nw < n) or (n < nw < w):
        if abs(w - nw) > 32 or abs(n - nw) > 32:
            return w + n - nw
        return (w + n) >> 1
    return w if abs(w - nw) > abs(n - nw) else n


def _nbits_for(c0_prev: int, small_run: int) -> tuple[int, int]:
    """Adaptive mantissa width from the previous same-parity magnitude.

    Returns (nbits, i2) where i2 is the 2-bit widening applied while the
    recent-magnitude run counter is low (dcraw's `i = 2*(carry[2] < 3)`).
    """
    i2 = 2 if small_run < 3 else 0
    nbits = 2 + i2
    while (c0_prev & 0xFFFF) >> (nbits + i2):
        nbits += 1
    return nbits, i2


def _decode_python(payload: bytes, width: int, height: int) -> np.ndarray:
    data = payload
    nbits_total = len(data) * 8
    pos = 0

    def get(n: int) -> int:
        nonlocal pos
        if pos + n > nbits_total:
            raise ValueError("ORF compressed: bitstream exhausted")
        v = 0
        for _ in range(n):
            v = (v << 1) | ((data[pos >> 3] >> (7 - (pos & 7))) & 1)
            pos += 1
        return v

    def unary12() -> int:
        nonlocal pos
        n = 0
        while n < 12:
            if pos >= nbits_total:
                raise ValueError("ORF compressed: bitstream exhausted")
            bit = (data[pos >> 3] >> (7 - (pos & 7))) & 1
            pos += 1
            if bit:
                return n
            n += 1
        return 12

    out = np.zeros((height, width), np.uint16)
    for row in range(height):
        carry = [[0, 0, 0], [0, 0, 0]]
        for col in range(width):
            c = carry[col & 1]
            nbits, _ = _nbits_for(c[0], c[2])
            b3 = get(3)
            low = b3 & 3
            sign = -1 if (b3 & 4) else 0
            high = unary12()
            if high == 12:
                high = get(16 - nbits) >> 1
            c0 = (high << nbits) | get(nbits)
            diff = (c0 ^ sign) + c[1]
            c[1] = (diff * 3 + c[1]) >> 5
            c[2] = 0 if c0 > 16 else c[2] + 1
            c[0] = c0
            pred = _predict(out, row, col)
            # (diff<<2)|low == diff*4 + low for any sign (low 2 bits of
            # diff*4 are clear); the u16 store wraps like dcraw's ushort.
            out[row, col] = (pred + diff * 4 + low) & 0xFFFF
    return out


def _decode_native(payload: bytes, width: int, height: int) -> np.ndarray:
    lib = native._lib
    fn = lib.olympus_decode
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_uint16)]
    out = np.empty((height, width), np.uint16)
    rc = fn(payload, len(payload), width, height,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
    if rc == 1:
        raise ValueError("ORF compressed: invalid decode geometry")
    if rc != 0:
        raise ValueError("ORF compressed: bitstream exhausted")
    return out


def decode_olympus(payload: bytes, width: int, height: int) -> np.ndarray:
    """Decode an Olympus-compressed ORF strip to a (height, width) u16
    sensor plane. Raises ValueError on truncated/corrupt streams."""
    payload = bytes(payload)
    if len(payload) <= _PREAMBLE:
        raise ValueError("ORF compressed: payload shorter than preamble")
    body = payload[_PREAMBLE:]
    if native.have_native() and hasattr(native._lib, "olympus_decode"):
        return _decode_native(body, width, height)
    return _decode_python(body, width, height)


def encode_olympus(img: np.ndarray) -> bytes:
    """Encode a u16 sensor plane (values < 2^15) as a canonical
    Olympus-compressed stream. Test/tooling aid: decode(encode(x)) == x
    through either decoder."""
    img = np.asarray(img)
    if img.ndim != 2:
        raise ValueError("expected a 2-D sensor plane")
    height, width = img.shape
    bits_out = bytearray()
    acc = 0
    nacc = 0

    def put(n: int, v: int) -> None:
        nonlocal acc, nacc
        acc = (acc << n) | (v & ((1 << n) - 1))
        nacc += n
        while nacc >= 8:
            nacc -= 8
            bits_out.append((acc >> nacc) & 0xFF)
        acc &= (1 << nacc) - 1

    out = np.zeros((height, width), np.uint16)
    for row in range(height):
        carry = [[0, 0, 0], [0, 0, 0]]
        for col in range(width):
            c = carry[col & 1]
            nbits, _ = _nbits_for(c[0], c[2])
            pred = _predict(out, row, col)
            val = int(img[row, col])
            if not 0 <= val <= 0xFFFF:
                raise ValueError("pixel out of u16 range")
            r = val - pred
            low = r & 3
            diff = r >> 2
            t = diff - c[1]
            if t >= 0:
                signbit, c0 = 0, t
            else:
                signbit, c0 = 1, -t - 1
            put(3, (signbit << 2) | low)
            high = c0 >> nbits
            if high < 12:
                put(high + 1, 1)          # `high` zeros then a 1
            else:
                put(12, 0)                # escape: 12 zeros
                esc = high << 1
                if esc >> (16 - nbits):
                    raise ValueError(
                        "residual too large for the olympus stream "
                        "(12-bit-range input expected)")
                put(16 - nbits, esc)
            put(nbits, c0 & ((1 << nbits) - 1))
            sign = -1 if signbit else 0
            d2 = (c0 ^ sign) + c[1]
            assert d2 == diff
            c[1] = (diff * 3 + c[1]) >> 5
            c[2] = 0 if c0 > 16 else c[2] + 1
            c[0] = c0
            out[row, col] = (pred + diff * 4 + low) & 0xFFFF
            if int(out[row, col]) != val:
                raise AssertionError("encoder self-check failed")
    if nacc:
        put(8 - nacc, 0)
    return b"\x00" * _PREAMBLE + bytes(bits_out)
