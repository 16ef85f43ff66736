"""The uncompressed DNG container (Adobe DNG Specification 1.4,
Compression = 1): a little-endian TIFF with one IFD, the CFA plane as one
strip of 16-bit samples, and the DNG tags of its levels, colour matrix,
as-shot neutral and orientation, as Adobe DNG Converter writes them
uncompressed. Rationals are over `synth.RATIONAL_DEN`."""

from __future__ import annotations

import struct

import numpy as np

from ..synth import EXIF_ORIENTATION, RATIONAL_DEN, Frame, cfa_grid

SUFFIX = ".dng"

_SHORT, _LONG, _BYTE, _ASCII, _RATIONAL, _SRATIONAL = 3, 4, 1, 2, 5, 10


def _pack(typ, vals) -> bytes:
    if typ == _SHORT:
        return struct.pack(f"<{len(vals)}H", *vals)
    if typ == _LONG:
        return struct.pack(f"<{len(vals)}I", *vals)
    if typ == _BYTE:
        return struct.pack(f"{len(vals)}B", *vals)
    if typ == _ASCII:
        return vals.encode("ascii") + b"\0"
    if typ == _RATIONAL:
        return struct.pack(f"<{2 * len(vals)}I", *[x for v in vals for x in (v, RATIONAL_DEN)])
    if typ == _SRATIONAL:
        return struct.pack(f"<{2 * len(vals)}i", *[x for v in vals for x in (v, RATIONAL_DEN)])
    raise ValueError(typ)


def encode(frame: Frame) -> bytes:
    """A little-endian TIFF with one IFD: the CFA plane as one uncompressed
    strip of 16-bit samples, and the DNG tags of its levels, colour matrix,
    as-shot neutral and orientation."""
    payload = np.ascontiguousarray(frame.data, "<u2").tobytes()
    grid = cfa_grid(frame.cfa, frame.cfa_dims)
    entries = [
        (254, _LONG, [0]), (256, _LONG, [frame.width]), (257, _LONG, [frame.height]),
        (258, _SHORT, [16]), (259, _SHORT, [1]), (262, _SHORT, [32803]),
        (271, _ASCII, "portbench"), (272, _ASCII, frame.model or "synthetic"),
        (273, _LONG, [0]), (274, _SHORT, [EXIF_ORIENTATION[frame.orientation]]),
        (277, _SHORT, [1]), (278, _LONG, [frame.height]), (279, _LONG, [len(payload)]),
        (33421, _SHORT, list(frame.cfa_dims)), (33422, _BYTE, [int(v) for v in grid.ravel()]),
        (50706, _BYTE, [1, 4, 0, 0]), (50714, _SHORT, [frame.black]),
        (50717, _SHORT, [frame.white]), (50719, _LONG, [0, 0]),
        (50720, _LONG, [frame.width, frame.height]),
        (50721, _SRATIONAL, frame.color_matrix), (50728, _RATIONAL, frame.neutral),
    ]
    n = len(entries)
    ext_off = 8 + 2 + 12 * n + 4
    ext = bytearray()
    packed = []
    for tag, typ, vals in entries:
        raw = _pack(typ, vals)
        count = len(raw) if typ in (_ASCII, _BYTE) else len(vals)
        if len(raw) <= 4:
            packed.append((tag, typ, count, raw.ljust(4, b"\0")))
        else:
            packed.append((tag, typ, count, struct.pack("<I", ext_off + len(ext))))
            ext += raw + (b"\0" if len(raw) % 2 else b"")
    strip_off = ext_off + len(ext)
    out = bytearray(struct.pack("<2sHI", b"II", 42, 8))
    out += struct.pack("<H", n)
    for tag, typ, count, value in packed:
        if tag == 273:
            value = struct.pack("<I", strip_off)
        out += struct.pack("<HHI", tag, typ, count) + value
    out += struct.pack("<I", 0)
    return bytes(out + ext) + payload
