"""Minolta MRW (DiMAGE / Dynax / Maxxum bodies).

The reference reaches Minolta bodies through rawloader at
the reference's src/pipeline.rs:264. The container (public, documented
by dcraw's `parse_minolta` and the widely-mirrored MRW format notes) is
a sequence of blocks after a "\\0MRM" magic whose 4th byte doubles as a
byte-order mark ('M' big-endian, 'I' little-endian):

  "\\0PRD"  8-byte version string, then u16 sensor height/width, u16
           image height/width, u8 data depth (12 or 16), u8 pixel
           depth, u8 storage method (0x52 = 12-bit packed big-endian,
           0x59 = plain 16-bit words), u8s incl. the bayer pattern code
  "\\0WBG"  4 per-channel denominator exponents, then 4 u16 multipliers
           in R G1 G2 B order
  "\\0RIF"  requester image format (ISO/WB mode etc. -- unused here)
  "\\0TTW"  an embedded standard TIFF/EXIF tree (Make/Model/Orientation)

The u32 after the magic is the total header length; sensor data starts
right after it (12-bit packed rows in the container's byte order, no
padding) -- decoded with the same native bit-unpackers the NEF path
uses.
"""

from __future__ import annotations

import struct

import numpy as np

from . import native
from .cameras import xyz_to_cam_for
from .raw import CFA, Orientation, RawImage
from .tiff import TiffFile, exif_to_orientation

__all__ = ["read_mrw"]

# PRD bayer-pattern byte -> CFA. 0x01 (RGGB) is what every known body
# writes; the map exists so an unknown code fails by name.
_CFA_BY_CODE = {0x01: "RGGB"}


def read_mrw(path: str) -> RawImage:
    with open(path, "rb") as f:
        buf = f.read()
    # The magic's 4th byte is a byte-order mark ('M' = big-endian, the
    # common case; 'I' = little-endian, e.g. DiMAGE A200) governing every
    # multi-byte integer in the container; block TAGS are plain 4-byte
    # strings either way (dcraw's parse_minolta semantics).
    if len(buf) < 8 or buf[:3] != b"\0MR" or buf[3:4] not in (b"M", b"I"):
        raise ValueError("not a Minolta MRW (missing \\0MRM magic)")
    en = ">" if buf[3:4] == b"M" else "<"
    (header_len,) = struct.unpack_from(en + "I", buf, 4)
    data_offset = header_len + 8
    if not 8 < data_offset <= len(buf):
        raise ValueError("MRW: implausible header length")

    height = width = 0
    depth = 12
    storage = 0x52
    cfa_code = 0x01
    wb = (float("nan"),) * 4
    make = model = ""
    orient = Orientation.Normal

    pos = 8
    while pos + 8 <= data_offset:
        tag = buf[pos:pos + 4]
        (blen,) = struct.unpack_from(en + "I", buf, pos + 4)
        body_off = pos + 8
        if body_off + blen > len(buf):
            raise ValueError("MRW: block overruns the file")
        if tag == b"\0PRD" and blen >= 24:
            height, width = struct.unpack_from(en + "HH", buf, body_off + 8)
            depth = buf[body_off + 16]
            storage = buf[body_off + 18]
            cfa_code = buf[body_off + 22]
        elif tag == b"\0WBG" and blen >= 12:
            denoms = struct.unpack_from("4B", buf, body_off)
            mults = struct.unpack_from(en + "4H", buf, body_off + 4)
            # stored R G1 G2 B, each scaled by 1<<(6+denom)
            vals = [m / (1 << (6 + d)) for m, d in zip(mults, denoms)]
            g = (vals[1] + vals[2]) / 2.0
            if g > 0:
                wb = (vals[0] / g, 1.0, vals[3] / g, float("nan"))
        elif tag == b"\0TTW" and blen >= 8:
            try:
                sub = TiffFile(bytes(buf[body_off:body_off + blen]))
                make = (sub.find1(271) or "").strip()
                model = (sub.find1(272) or "").strip()
                o = sub.find1(274)
                if o:
                    got = exif_to_orientation(int(o))
                    if got is not None:
                        orient = got
            except ValueError:
                pass  # a broken embedded EXIF tree only loses metadata
        pos = body_off + blen

    if not width or not height or width * height > 500_000_000:
        raise ValueError("MRW: missing/implausible PRD dimensions")
    if depth not in (12, 16):
        raise ValueError(f"MRW: unsupported data depth {depth}")
    cfa_name = _CFA_BY_CODE.get(cfa_code)
    if cfa_name is None:
        raise ValueError(f"MRW: unrecognized bayer pattern code "
                         f"{cfa_code:#x}")

    npix = width * height
    payload = np.frombuffer(buf, np.uint8, offset=data_offset)
    if storage == 0x52:  # 12-bit packed (container byte order)
        need = (npix * 12 + 7) // 8
        if len(payload) < need:
            raise ValueError("MRW: truncated 12-bit packed payload")
        unpack = native.unpack_12be if en == ">" else native.unpack_12le
        data = unpack(payload[:need], npix).reshape(height, width)
    elif storage == 0x59:  # plain 16-bit words (container byte order)
        if len(payload) < npix * 2:
            raise ValueError("MRW: truncated 16-bit payload")
        data = np.frombuffer(
            buf, en + "u2", count=npix, offset=data_offset
        ).astype(np.uint16).reshape(height, width)
    else:
        raise ValueError(f"MRW: unrecognized storage method {storage:#x}")

    white = (1 << depth) - 1
    return RawImage(
        width=width, height=height, cpp=1, crops=(0, 0, 0, 0),
        blacklevels=(0,) * 4, whitelevels=(white,) * 4,
        wb_coeffs=wb, xyz_to_cam=xyz_to_cam_for(make or "Minolta", model),
        orientation=orient, cfa=CFA(cfa_name), data=data,
        make=make or "Minolta", model=model)
