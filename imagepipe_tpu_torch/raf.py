"""Fujifilm RAF container reader (classic CFA-record flavor).

Covers the rawloader surface the reference reaches through
the reference's src/pipeline.rs:264 for Fuji bodies: the proprietary RAF
wrapper (it is NOT a TIFF) around an uncompressed 16-bit X-Trans sensor
dump. Layout:

  0x00  16 bytes  magic "FUJIFILMCCD-RAW "
  0x10   4 bytes  format version (ascii)
  0x14   8 bytes  camera number id
  0x1c  32 bytes  camera model (nul padded)
  0x3c   4 bytes  directory version
  0x54  u32be x6  jpeg offset/len, meta offset/len, cfa offset/len

The meta block is a big-endian record list (u32 count, then
{u16 tag, u16 size, bytes}):

  0x0100  sensor dims (u16 height, u16 width)
  0x0131  X-Trans 6x6 pattern, 36 bytes of 0/1/2 color codes stored in
          reverse raster order (dcraw's parse_fuji semantics)
  0x2ff0  white balance, four u16: G, R, G2, B (dcraw's c^1 swizzle)

The CFA payload is big-endian u16 raster data in the classic flavor;
newer bodies wrap an embedded TIFF whose FujiIFD (tag 0xF000) carries
dims/bits/strips/black level, decoded by _read_tiff_wrapped —
uncompressed 16-bit strips, or the fuji lossless-compressed stream
(0x4953 signature; `fujic.py`) that every X-T3-onward body writes by
default. Classic SuperCCD records (0x0130 layout flags) decode onto
their true diagonal lattice as a 2x4/4x2-periodic CFA (superccd_cfa);
classic Bayer bodies resolve their pattern through the per-model
registry. Only a body with neither record nor registry entry refuses.
"""

from __future__ import annotations

import struct

import numpy as np

from .cameras import xyz_to_cam_for
from .raw import CFA, Orientation, RawImage

__all__ = ["read_raf", "RAF_MAGIC", "superccd_cfa", "superccd_geometry",
           "register_raf_pattern", "register_raf_levels"]

RAF_MAGIC = b"FUJIFILMCCD-RAW "

_CODE_TO_LETTER = {0: "R", 1: "G", 2: "B", 3: "E"}


def _records(buf: bytes, off: int, length: int) -> dict[int, bytes]:
    end = min(off + length, len(buf))
    if off + 4 > len(buf):
        raise ValueError("RAF: meta block out of bounds")
    (count,) = struct.unpack_from(">I", buf, off)
    if count > 4096:
        raise ValueError("RAF: implausible meta record count")
    recs: dict[int, bytes] = {}
    p = off + 4
    for _ in range(count):
        if p + 4 > end:
            raise ValueError("RAF: truncated meta record")
        tag, size = struct.unpack_from(">HH", buf, p)
        p += 4
        if p + size > end:
            raise ValueError("RAF: meta record payload out of bounds")
        recs[tag] = buf[p:p + size]
        p += size
    return recs


def read_raf(path: str) -> RawImage:
    with open(path, "rb") as f:
        buf = f.read()
    if len(buf) < 0x70 or buf[:16] != RAF_MAGIC:
        raise ValueError("not a RAF container")
    model = buf[0x1C:0x3C].split(b"\0", 1)[0].decode("ascii", "replace").strip()
    (_jpeg_off, _jpeg_len, meta_off, meta_len, cfa_off, cfa_len
     ) = struct.unpack_from(">IIIIII", buf, 0x54)

    # Meta records are best-effort here: the classic path requires dims and
    # pattern; TIFF-wrapped files carry dims inside the embedded FujiIFD.
    try:
        recs = _records(buf, meta_off, meta_len)
    except ValueError:
        recs = {}

    cfa = None
    pat = recs.get(0x0131)
    if pat is not None and len(pat) == 36:
        # dcraw parse_fuji reads the 36 bytes in reverse raster order.
        codes = [b & 3 for b in pat[::-1]]
        cfa = CFA("".join(_CODE_TO_LETTER[c] for c in codes))

    wb = (float("nan"),) * 4
    wbrec = recs.get(0x2FF0)
    if wbrec is not None and len(wbrec) >= 8:
        g, r, g2, b = struct.unpack_from(">HHHH", wbrec, 0)
        if g > 0:
            wb = (r / g, 1.0, b / g, float("nan"))

    if cfa_off + 2 > len(buf):
        raise ValueError("RAF: CFA payload out of bounds")
    if buf[cfa_off:cfa_off + 4] in (b"II*\0", b"MM\0*"):
        # Newer bodies wrap the sensor dump in an embedded TIFF (FujiIFD).
        return _read_tiff_wrapped(buf, cfa_off, cfa_len, model, cfa, wb)

    dims = recs.get(0x0100)
    if dims is None or len(dims) < 4:
        raise ValueError("RAF: missing sensor dimensions record (0x0100)")
    height, width = struct.unpack_from(">HH", dims, 0)
    if height <= 0 or width <= 0 or height * width > 500_000_000:
        raise ValueError("RAF: implausible sensor dimensions")

    # SuperCCD layout flags (dcraw parse_fuji's 0x0130 record): byte 0's
    # top bit selects the HR ("layout 1") lattice orientation; byte 1's
    # bit 3 CLEAR marks a diagonal (SuperCCD) sensor.
    layout_rec = recs.get(0x0130)
    superccd = False
    layout = 0
    if layout_rec is not None and len(layout_rec) >= 2:
        layout = layout_rec[0] >> 7
        superccd = not (layout_rec[1] & 8)

    crops = (0, 0, 0, 0)
    usable = recs.get(0x0121)
    if usable is not None and len(usable) >= 4:
        uh, uw = struct.unpack_from(">HH", usable, 0)
        if uw == 4284:
            uw += 3   # dcraw parse_fuji's documented S2Pro width fixup
        if 0 < uh <= height and 0 < uw <= width:
            crops = (0, width - uw, height - uh, 0)

    if cfa is None and superccd:
        uw = width - crops[1]
        fuji_width = uw >> (0 if layout else 1)
        cfa = superccd_cfa(fuji_width, layout)
    if cfa is None:
        # Classic Bayer bodies carry no pattern record; the per-model
        # registry is the provenance-safe source (same contract as the
        # TIFF-wrapped path).
        cfa = _PATTERNS.get((model or "").strip().upper())
    if cfa is None:
        raise ValueError(
            "RAF: no CFA pattern record (0x0131), no SuperCCD layout "
            "record, and no registered pattern for this body; register "
            "one with register_raf_pattern")
    need = height * width * 2
    if cfa_len < need or cfa_off + need > len(buf):
        raise ValueError("RAF: CFA payload truncated "
                         f"(need {need} bytes, have {min(cfa_len, len(buf) - cfa_off)})")
    data = np.frombuffer(buf, dtype=">u2", count=height * width,
                         offset=cfa_off).astype(np.uint16).reshape(height, width)

    # Classic RAF carries no black/white level records; like rawloader,
    # levels come from the per-body registry (X-Trans sensors are 14-bit).
    black, white = raf_levels_for(model)
    return RawImage(
        width=width, height=height, cpp=1, crops=crops,
        blacklevels=(black,) * 4, whitelevels=(white,) * 4,
        wb_coeffs=wb, xyz_to_cam=xyz_to_cam_for("FUJIFILM", model),
        orientation=Orientation.Normal, cfa=cfa, data=data,
        make="FUJIFILM", model=model)


def superccd_cfa(fuji_width: int, layout: int) -> CFA:
    """The SuperCCD diagonal lattice expressed as a periodic CFA in RAW
    coordinates.

    dcraw's fuji_load_raw documents the bijection from raw (row, col) to
    the 45-degree upright frame (r, c) and assigns each sample the color
    FC(r, c) of a plain 2x2 mosaic there (BGGR, or GBRG when fuji_width
    is even). Composing the two yields a 2x4-periodic (layout 0) or
    4x2-periodic (layout 1) pattern in raw coordinates -- so the sensor
    demosaics natively on its true lattice through the generic-CFA
    engine, with NO holed intermediate grid; square-pixel geometry is
    restored afterwards by one anisotropic resample (superccd_geometry),
    which is what dcraw's fuji_rotate approximates bilinearly.

    Upright mosaic per dcraw parse_fuji: `filters = fuji_width & 1 ?
    0x94949494 : 0x49494949` = RGGB for odd widths, GBRG for even."""
    base = CFA("GBRG" if fuji_width % 2 == 0 else "RGGB")
    h, w = (4, 2) if layout else (2, 4)
    letters = []
    for row in range(h):
        for col in range(w):
            if layout:
                r = fuji_width - 1 - col + (row >> 1)
                c = col + ((row + 1) >> 1)
            else:
                r = fuji_width - 1 + row - (col >> 1)
                c = row + ((col + 1) >> 1)
            letters.append("RGBE"[base.color_at(r % 2, c % 2)])
    return CFA("".join(letters), height=h, width=w)


def superccd_geometry(height: int, width: int,
                      layout: int = 0) -> tuple[int, int]:
    """Square-pixel output size for a demosaiced SuperCCD raw plane.

    The diagonal lattice's raw grid is anisotropic: restoring square
    pixels resamples rows by sqrt(2) and columns by 1/sqrt(2) (layout 0;
    swapped for layout 1) -- the same geometry dcraw's fuji_rotate
    produces via its 45-degree bilinear walk, derived by composing
    fuji_load_raw's lattice map with fuji_rotate's step = sqrt(0.5)
    sampling. Feed the result to the maxsize/scaling ops."""
    s = float(np.sqrt(2.0))
    if layout:
        return int(round(height / s)), int(round(width * s))
    return int(round(height * s)), int(round(width / s))


# FujiIFD tags of the TIFF-wrapped CFA section (exiftool's FujiIFD table).
_F_IFD = 0xF000
_F_WIDTH = 0xF001
_F_HEIGHT = 0xF002
_F_BITS = 0xF003
_F_STRIP_OFFSETS = 0xF007
_F_STRIP_BYTECOUNTS = 0xF008
_F_BLACK = 0xF00A

def _read_tiff_wrapped(buf, cfa_off, cfa_len, model, cfa, wb) -> RawImage:
    """Newer-body RAF: the CFA section is an embedded TIFF whose FujiIFD
    (tag 0xF000 in IFD0) carries dims/bits/strips. Payloads are plain
    16-bit strips or the fuji lossless-compressed stream (fujic.py).
    The CFA pattern must come from the file's 0x0131 record or the
    per-model registry -- no hardcoded fallback (a wrong mosaic silently
    corrupts colors, the exact failure this module's contract forbids)."""
    from .tiff import TiffFile

    if cfa is None:
        cfa = _PATTERNS.get((model or "").strip().upper())
    if cfa is None:
        raise ValueError(
            "RAF: no X-Trans pattern record (0x0131) and no registered "
            "pattern for this body; register one with register_raf_pattern")

    sub = bytes(buf[cfa_off:cfa_off + cfa_len])
    tf = TiffFile(sub)
    width = tf.find1(_F_WIDTH, 0)
    height = tf.find1(_F_HEIGHT, 0)
    bits = tf.find1(_F_BITS, 14)
    offs = tf.find(_F_STRIP_OFFSETS)
    cnts = tf.find(_F_STRIP_BYTECOUNTS)
    if not width or not height or width * height > 500_000_000:
        raise ValueError("RAF: FujiIFD missing/implausible raw dimensions")
    if not 8 <= bits <= 16:
        raise ValueError(f"RAF: implausible FujiIFD bit depth {bits}")
    if not offs or not cnts:
        raise ValueError("RAF: FujiIFD has no strip layout")
    need = height * width * 2
    if sum(int(c) for c in cnts) < need:
        # Short strips mean fuji-compressed payload (the 0x4953-signature
        # lossless stream) or a truncated file; check the layout against
        # the sub-TIFF extent so the error names the right problem.
        if any(int(o) + int(c) > len(sub) for o, c in zip(offs, cnts)):
            raise ValueError("RAF: FujiIFD strips truncated "
                             "(layout extends past the file)")
        from .fujic import decode_fuji

        # One logical bitstream: concatenate every strip (files are
        # single-strip in practice, but a split layout must not silently
        # truncate the stream -- same rule as the NEF 34713 path).
        blob = b"".join(bytes(sub[int(o):int(o) + int(c)])
                        for o, c in zip(offs, cnts))
        data, hdr = decode_fuji(blob, cfa_grid=cfa.pattern)
        if hdr.raw_width < width or hdr.raw_height < height:
            raise ValueError(
                f"RAF: compressed stream geometry {hdr.raw_width}x"
                f"{hdr.raw_height} smaller than FujiIFD dims "
                f"{width}x{height}")
        data = np.ascontiguousarray(data[:height, :width])
        if hdr.raw_bits != bits:
            bits = hdr.raw_bits  # the stream header is authoritative
    else:
        u2 = tf.endian + "u2"  # honor the embedded TIFF's byte order
        parts = []
        got = 0
        for off, cnt in zip(offs, cnts):
            off, cnt = int(off), int(cnt)
            if off + cnt > len(sub):
                raise ValueError("RAF: FujiIFD strip out of bounds")
            parts.append(np.frombuffer(sub, dtype=u2, count=cnt // 2,
                                       offset=off))
            got += cnt // 2
            if got * 2 >= need:
                break
        data = np.concatenate(parts)[: height * width].astype(
            np.uint16).reshape(height, width)

    blk = tf.find(_F_BLACK)
    if blk:
        black = int(round(sum(blk[:4]) / len(blk[:4])))
        white = (1 << bits) - 1
    else:
        black, white = raf_levels_for(model)
    return RawImage(
        width=width, height=height, cpp=1, crops=(0, 0, 0, 0),
        blacklevels=(black,) * 4, whitelevels=(white,) * 4,
        wb_coeffs=wb, xyz_to_cam=xyz_to_cam_for("FUJIFILM", model),
        orientation=Orientation.Normal, cfa=cfa, data=data,
        make="FUJIFILM", model=model)


# model (uppercased) -> (black, white); 14-bit default otherwise. Every
# body registered in cameras.py must have an entry here: classic RAF files
# carry no level records, and a 0 black level visibly washes out shadows
# (these sensors sit ~1022 counts above true black). Values follow the
# public rawloader/dcraw per-body tables (14-bit X-Trans: black 1022,
# white 16383).
_LEVELS: dict[str, tuple[int, int]] = {
    # X-Trans III family (24MP, 14-bit).
    "X-T2": (1022, 16383),
    "X-PRO2": (1022, 16383),
    "X-T20": (1022, 16383),
    "X-E3": (1022, 16383),
    "X-H1": (1022, 16383),
    "X100F": (1022, 16383),
    # X-Trans IV family (26MP, 14-bit).
    "X-T30": (1022, 16383),
    "X-T3": (1022, 16383),
    "X-T4": (1022, 16383),
    "X-PRO3": (1022, 16383),
    "X-S10": (1022, 16383),
    "X100V": (1022, 16383),
}


def raf_levels_for(model: str) -> tuple[int, int]:
    return _LEVELS.get((model or "").strip().upper(), (0, 16383))


def register_raf_levels(model: str, black: int, white: int) -> None:
    _LEVELS[model.strip().upper()] = (int(black), int(white))


# model (uppercased) -> CFA for TIFF-wrapped files lacking the 0x0131 record.
_PATTERNS: dict[str, CFA] = {}


def register_raf_pattern(model: str, pattern: str) -> None:
    """Register a body's CFA pattern (e.g. a 36-char X-Trans string) for
    TIFF-wrapped RAFs that omit the classic pattern record."""
    _PATTERNS[model.strip().upper()] = CFA(pattern)
