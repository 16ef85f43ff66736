"""Hardened TIFF/TIFF-EP container walker shared by the DNG and vendor RAW
readers (NEF/CR2/ARW are all TIFF-EP containers; reference surface:
rawloader's per-format parsers behind the reference's src/pipeline.rs:264).

Every offset and size is bounds-checked against the file buffer and IFD
chains are loop-guarded, so truncated, looping, or hostile files raise
ValueError instead of crashing or hanging (the L0 failure-isolation
contract, SURVEY.md section 5).
"""

from __future__ import annotations

import struct
from typing import Optional

__all__ = ["TiffFile", "Ifd", "TYPE_SIZES"]

TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
              11: 4, 12: 8}

# Tags the walker itself understands.
T_SUBIFDS = 330
T_EXIF_IFD = 34665
T_MAKERNOTE = 37500
T_FUJI_IFD = 0xF000  # RAF: embedded-TIFF FujiIFD pointer

# Baseline TIFF-EP tag ids shared by every reader built on this walker.
T_WIDTH = 256
T_LENGTH = 257
T_BITS = 258
T_COMPRESSION = 259
T_PHOTOMETRIC = 262
T_MAKE = 271
T_MODEL = 272
T_STRIP_OFFSETS = 273
T_ORIENTATION = 274
T_ROWS_PER_STRIP = 278
T_STRIP_BYTECOUNTS = 279
T_CFA_REPEAT = 33421
T_CFA_PATTERN = 33422


_ORIENT_TABLE = None


def exif_to_orientation(value: int):
    """EXIF orientation tag value -> raw.Orientation (shared by every
    container reader; imported lazily to keep tiff.py dependency-free)."""
    global _ORIENT_TABLE
    if _ORIENT_TABLE is None:
        from .raw import Orientation

        _ORIENT_TABLE = {
            1: Orientation.Normal, 2: Orientation.HorizontalFlip,
            3: Orientation.Rotate180, 4: Orientation.VerticalFlip,
            5: Orientation.Transpose, 6: Orientation.Rotate90,
            7: Orientation.Transverse, 8: Orientation.Rotate270,
        }
    return _ORIENT_TABLE.get(int(value), _ORIENT_TABLE[1])

_MAX_IFDS = 64
_MAX_ENTRIES = 512


class Ifd:
    """One parsed IFD: {tag: (type, count, data_offset)} plus helpers."""

    def __init__(self, tiff: "TiffFile", entries: dict, offset: int):
        self._tiff = tiff
        self.entries = entries
        self.offset = offset

    def __contains__(self, tag: int) -> bool:
        return tag in self.entries

    def get(self, tag: int, default=None):
        """Decoded value list for a tag, or default."""
        if tag not in self.entries:
            return default
        return self._tiff.values(self.entries[tag])

    def get1(self, tag: int, default=None):
        v = self.get(tag)
        return v[0] if v else default

    def raw_bytes(self, tag: int) -> Optional[bytes]:
        """The tag's payload bytes, unparsed (for maker notes / blobs)."""
        if tag not in self.entries:
            return None
        typ, count, off = self.entries[tag]
        size = TYPE_SIZES.get(typ, 1) * count
        self._tiff._check(off, size, f"tag {tag} payload")
        return bytes(self._tiff.buf[off:off + size])


class TiffFile:
    """Parse a TIFF buffer: header, IFD chain, SubIFD trees, EXIF IFD.

    `base` offsets all pointers (maker notes embed TIFF streams whose
    offsets are relative to the note, not the file).
    """

    def __init__(self, buf: bytes, base: int = 0, magics=(42,)):
        self.buf = buf
        self.base = base
        if len(buf) < base + 8:
            raise ValueError("TIFF: truncated header")
        bom = buf[base:base + 2]
        if bom == b"II":
            self.endian = "<"
        elif bom == b"MM":
            self.endian = ">"
        else:
            raise ValueError("TIFF: bad byte-order mark")
        magic, first = struct.unpack_from(self.endian + "HI", buf, base + 2)
        # Some vendors stamp their own magic into an otherwise-standard
        # TIFF header (ORF: 0x4F52 'RO' / 0x5352 'RS').
        if magic not in magics:
            raise ValueError(f"TIFF: bad magic {magic}")
        self.ifds: list[Ifd] = []
        self._walk(first)

    # -- low level ----------------------------------------------------------

    def _check(self, off: int, size: int, what: str) -> None:
        if off < 0 or size < 0 or off + size > len(self.buf):
            raise ValueError(f"TIFF: {what} out of bounds "
                             f"({off}+{size} > {len(self.buf)})")

    def _read_ifd(self, offset: int):
        off = self.base + offset
        self._check(off, 2, "IFD header")
        (n,) = struct.unpack_from(self.endian + "H", self.buf, off)
        if n > _MAX_ENTRIES:
            raise ValueError(f"TIFF: IFD entry count {n} over limit")
        self._check(off, 2 + n * 12 + 4, "IFD body")
        entries = {}
        for i in range(n):
            tag, typ, count = struct.unpack_from(
                self.endian + "HHI", self.buf, off + 2 + i * 12)
            val_off = off + 2 + i * 12 + 8
            size = TYPE_SIZES.get(typ, 1) * count
            if size > 4:
                (ptr,) = struct.unpack_from(self.endian + "I", self.buf, val_off)
                data_off = self.base + ptr
            else:
                data_off = val_off
            entries[tag] = (typ, count, data_off)
        (next_off,) = struct.unpack_from(
            self.endian + "I", self.buf, off + 2 + n * 12)
        return entries, next_off

    def values(self, entry) -> list:
        typ, count, off = entry
        size = TYPE_SIZES.get(typ, 1) * count
        self._check(off, size, "tag values")
        buf, endian = self.buf, self.endian
        if typ == 3:
            return list(struct.unpack_from(endian + f"{count}H", buf, off))
        if typ == 8:
            return list(struct.unpack_from(endian + f"{count}h", buf, off))
        if typ == 4:
            return list(struct.unpack_from(endian + f"{count}I", buf, off))
        if typ == 9:
            return list(struct.unpack_from(endian + f"{count}i", buf, off))
        if typ in (1, 6, 7):
            return list(struct.unpack_from(f"{count}B", buf, off))
        if typ == 5:  # RATIONAL
            raw = struct.unpack_from(endian + f"{2 * count}I", buf, off)
            return [raw[2 * i] / raw[2 * i + 1] if raw[2 * i + 1] else 0.0
                    for i in range(count)]
        if typ == 10:  # SRATIONAL
            raw = struct.unpack_from(endian + f"{2 * count}i", buf, off)
            return [raw[2 * i] / raw[2 * i + 1] if raw[2 * i + 1] else 0.0
                    for i in range(count)]
        if typ == 11:
            return list(struct.unpack_from(endian + f"{count}f", buf, off))
        if typ == 12:
            return list(struct.unpack_from(endian + f"{count}d", buf, off))
        if typ == 2:
            return [bytes(buf[off:off + count]).split(b"\0")[0]
                    .decode("ascii", "replace")]
        raise ValueError(f"TIFF: unhandled type {typ}")

    # -- walking ------------------------------------------------------------

    def _walk(self, first: int) -> None:
        stack = [first]
        seen: set[int] = set()
        while stack:
            off = stack.pop()
            if off == 0 or off in seen:
                continue
            if len(self.ifds) >= _MAX_IFDS:
                raise ValueError("TIFF: IFD count over limit (offset loop?)")
            seen.add(off)
            try:
                entries, nxt = self._read_ifd(off)
            except ValueError:
                # Garbage next-IFD/SubIFD pointers (common in files rewritten
                # by editing tools) skip that chain rather than failing the
                # whole file; a broken PRIMARY IFD is still a hard error.
                if not self.ifds:
                    raise
                continue
            self.ifds.append(Ifd(self, entries, off))
            if nxt:
                stack.append(nxt)
            for chain_tag in (T_SUBIFDS, T_EXIF_IFD, T_FUJI_IFD):
                if chain_tag in entries:
                    try:
                        ptrs = self.values(entries[chain_tag])
                    except ValueError:
                        continue
                    stack.extend(int(p) for p in ptrs)

    # -- queries ------------------------------------------------------------

    def find(self, tag: int) -> Optional[list]:
        """First decoded value list for tag across all IFDs."""
        for ifd in self.ifds:
            if tag in ifd:
                try:
                    return ifd.get(tag)
                except ValueError:
                    continue
        return None

    def find1(self, tag: int, default=None):
        v = self.find(tag)
        return v[0] if v else default

    def ifds_with(self, tag: int) -> list[Ifd]:
        return [ifd for ifd in self.ifds if tag in ifd]

    def find_raw_bytes(self, tag: int) -> Optional[bytes]:
        """First raw (undecoded) payload for tag across all IFDs."""
        for ifd in self.ifds:
            blob = ifd.raw_bytes(tag)
            if blob is not None:
                return blob
        return None

    def makernote(self) -> Optional[bytes]:
        """The EXIF MakerNote payload, if any."""
        for ifd in self.ifds:
            blob = ifd.raw_bytes(T_MAKERNOTE)
            if blob is not None:
                return blob
        return None
