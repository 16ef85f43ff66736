"""Phase One IIQ: container reader + the Phase One raw codecs.

The reference reaches Phase One backs through rawloader at
the reference's src/pipeline.rs:264. IIQ files are NOT TIFF: they open
with an 8-byte file magic ("IIII" little-endian / "MMMM" big-endian plus
a 4-byte field), and at offset 8 a self-contained "Raw" header: a 2-byte
order mark, a version byte + "waR" signature dword, and the offset of a
flat directory of 16-byte (tag, type, len, data) entries. Integer values
ride in the `data` field; arrays live at `base + data`. Tags (public
dcraw/LibRaw `parse_phase_one` semantics):

  0x100  orientation (2-bit code -> 0/90/180/270)
  0x106  ROMM->camera 3x3 color matrix (9 floats)
  0x107  as-shot WB multipliers (3 floats, R G B)
  0x108/0x109  raw width / height
  0x10a..0x10d left margin / top margin / visible width / height
  0x10e  format: 0..2 = uncompressed 16-bit (with an XOR key swizzle
         when nonzero), >=3 = the compressed codec (5 adds a lossy
         sqrt-companding curve below 256; 8 is the unshifted variant)
  0x10f  raw data offset    0x112  the XOR key pair (in the data field)
  0x21c  per-row strip-offset table    0x21d  scalar black
  0x222/0x223  split column / column-pair black table (signed, per row)
  0x224/0x225  split row / row-pair black table (signed, per column)
  0x301  model string

The compressed codec is a per-row bitstream (rows independent via the
strip-offset table): 32-bit little-endian words consumed MSB-first.
Pixels pair into two parity chains; every 8 columns a unary-coded update
(1 = keep; j zeros + terminator = pick from the public length-pair table
{8,7},{6,9},{11,10},{5,12},{14,13}) sets each chain's difference length;
length 14 means a raw 16-bit value, otherwise the chain's predictor
steps by `bits(len) + 1 - 2^(len-1)`. The trailing `width % 8` columns
are always raw 16-bit. Format != 8 output is shifted left 2; scalar and
split col/row black corrections are applied dcraw-style (clamp at 0).

The decoder prefers the native C++ implementation (native/iiq.cc, via
ctypes) and falls back to pure Python; the canonical encoder exists for
tests (the scheme is lossless -- length 14 always represents) so
decode(encode(x)) round-trips pin every mechanism and python<->native
differential fuzz pins the two decoders to each other. As with the
other vendor codecs, the recalled bit layout and the 8-byte file-magic
placement await real-file confirmation (tests/test_realfiles.py)."""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from . import native
from .cameras import xyz_to_cam_for
from .raw import CFA, Orientation, RawImage

__all__ = ["read_iiq", "decode_phase_one", "encode_phase_one",
           "unswizzle_phase_one", "swizzle_phase_one", "romm_to_xyz_to_cam"]

# Difference-length pair table, indexed by (unary_zeros - 1) * 2 + bit.
_LEN_TABLE = (8, 7, 6, 9, 11, 10, 5, 12, 14, 13)
# Inverse: length -> (unary_zeros, bit).
_LEN_CODE = {l: (i // 2 + 1, i % 2) for i, l in enumerate(_LEN_TABLE)}


class _Ph1Bits:
    """dcraw's ph1_bits: 32-bit words in the CONTAINER's byte order
    (get4 honors the order mark; real files are "IIII" so little-endian
    is the common case), bits MSB-first within each word, buffered in a
    64-bit cache."""

    def __init__(self, data: bytes, pos: int, en: str = "<"):
        self.data = data
        self.pos = pos
        self.fmt = en + "I"
        self.bitbuf = 0
        self.vbits = 0

    def __call__(self, n: int) -> int:
        if n == 0:
            return 0
        if self.vbits < n:
            if self.pos + 4 > len(self.data):
                raise ValueError("IIQ: bitstream exhausted")
            (w,) = struct.unpack_from(self.fmt, self.data, self.pos)
            self.pos += 4
            self.bitbuf = ((self.bitbuf << 32) | w) & 0xFFFFFFFFFFFFFFFF
            self.vbits += 32
        c = ((self.bitbuf << (64 - self.vbits)) & 0xFFFFFFFFFFFFFFFF) >> (64 - n)
        self.vbits -= n
        return c


def _decode_python(data: bytes, offsets: np.ndarray, width: int,
                   height: int, en: str = "<") -> np.ndarray:
    out = np.zeros((height, width), np.uint16)
    tail_start = width & ~7
    # The two chains' difference lengths persist ACROSS rows (dcraw
    # declares len[] outside the row loop); a row may open with "keep".
    ln = [0, 0]
    for row in range(height):
        off = int(offsets[row])
        if not 0 <= off <= len(data):
            raise ValueError("IIQ: strip offset out of range")
        bits = _Ph1Bits(data, off, en)
        pred = [0, 0]
        for col in range(width):
            if col >= tail_start:
                # dcraw assigns the persistent state here, so a following
                # row's "keep" after a ragged tail keeps 14.
                ln[0] = ln[1] = l = 14
            else:
                if (col & 7) == 0:
                    for i in range(2):
                        j = 0
                        while j < 5 and not bits(1):
                            j += 1
                        if j:
                            ln[i] = _LEN_TABLE[(j - 1) * 2 + bits(1)]
                l = ln[col & 1]
                if l == 0:
                    raise ValueError(
                        "IIQ: difference length never established")
            p = col & 1
            if l == 14:
                pred[p] = bits(16)
            else:
                pred[p] += bits(l) + 1 - (1 << (l - 1))
            if pred[p] < 0 or pred[p] > 0xFFFF:
                raise ValueError("IIQ: predictor out of range "
                                 "(corrupt stream)")
            out[row, col] = pred[p]
    return out


def _decode_native(data: bytes, offsets: np.ndarray, width: int,
                   height: int, en: str = "<") -> np.ndarray:
    lib = native._lib
    fn = lib.iiq_decode
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                   ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
                   ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_uint16)]
    offs = np.ascontiguousarray(offsets, np.int64)
    out = np.empty((height, width), np.uint16)
    rc = fn(data, len(data),
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            width, height, 1 if en == ">" else 0,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
    if rc != 0:
        raise ValueError(f"IIQ: corrupt compressed stream (rc={rc})")
    return out


# Lossy format-5 companding curve: 8-bit codes below 256 decompand to
# i*i/3.969 + 0.5 (dcraw phase_one_load_raw_c's curve).
_FMT5_CURVE = (np.arange(256, dtype=np.float64) ** 2 / 3.969 + 0.5).astype(
    np.uint16)


def decode_phase_one(data: bytes, offsets, width: int, height: int,
                     fmt: int = 3, en: str = "<") -> np.ndarray:
    """Decode a compressed Phase One payload. `data` is the blob at the
    raw-data offset; `offsets` the per-row strip offsets into it; `en`
    the container byte order the 32-bit stream words follow."""
    offsets = np.asarray(offsets, np.int64)
    if offsets.shape != (height,):
        raise ValueError("IIQ: need one strip offset per raw row")
    if native.have_native() and hasattr(native._lib, "iiq_decode"):
        out = _decode_native(bytes(data), offsets, width, height, en)
    else:
        out = _decode_python(bytes(data), offsets, width, height, en)
    if fmt == 5:
        low = out < 256
        out[low] = _FMT5_CURVE[out[low]]
    return out


class _Ph1BitsWriter:
    """Mirror of _Ph1Bits: accumulates MSB-first bits, flushes 32-bit
    words in the container byte order."""

    def __init__(self, en: str = "<"):
        self.en = en
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

    def row_bytes(self) -> bytes:
        if self.nacc:
            self.put(32 - self.nacc, 0)
        return struct.pack(f"{self.en}{len(self.words)}I", *self.words)


def _len_for(deltas) -> int:
    """Smallest table length representing every delta, or 14 (raw)."""
    for l in sorted(set(_LEN_TABLE) - {14}):
        lo, hi = 1 - (1 << (l - 1)), 1 << (l - 1)
        if all(lo <= d <= hi for d in deltas):
            return l
    return 14


def encode_phase_one(img: np.ndarray,
                     en: str = "<") -> tuple[bytes, np.ndarray]:
    """Encode a u16 plane as a compressed Phase One payload (lossless --
    length 14 carries any 16-bit value). Returns (data, strip_offsets).

    Each row restates both chains' lengths at its first group (the
    decoder's length state persists across rows, but an explicit code is
    always legal), so rows stay independently decodable."""
    img = np.asarray(img)
    if img.ndim != 2 or img.dtype != np.uint16:
        raise ValueError("expected a 2-D u16 sensor plane")
    height, width = img.shape
    tail_start = width & ~7
    offsets = np.zeros(height, np.int64)
    blob = bytearray()
    ln = [0, 0]
    for row in range(height):
        offsets[row] = len(blob)
        w = _Ph1BitsWriter(en)
        pred = [0, 0]
        first_group = True
        for g in range(0, tail_start, 8):
            # Pick each chain's length over its 4 pixels in this group.
            want = [0, 0]
            for p in (0, 1):
                vals = [int(img[row, c]) for c in range(g + p, g + 8, 2)]
                deltas, pr = [], pred[p]
                for v in vals:
                    deltas.append(v - pr)
                    pr = v
                want[p] = _len_for(deltas)
            for p in (0, 1):
                if want[p] == ln[p] and not first_group:
                    w.put(1, 1)  # keep
                else:
                    zeros, bit = _LEN_CODE[want[p]]
                    w.put(zeros, 0)
                    if zeros < 5:
                        w.put(1, 1)
                    w.put(1, bit)
                    ln[p] = want[p]
            first_group = False
            for col in range(g, g + 8):
                p, l, v = col & 1, ln[col & 1], int(img[row, col])
                if l == 14:
                    w.put(16, v)
                else:
                    w.put(l, v - pred[p] - 1 + (1 << (l - 1)))
                pred[p] = v
        for col in range(tail_start, width):
            w.put(16, int(img[row, col]))
            pred[col & 1] = int(img[row, col])
        blob += w.row_bytes()
    return bytes(blob), offsets


# Pair-swizzle bit masks, dcraw phase_one_load_raw:
#   mask = ph1.format == 1 ? 0x5555 : 0x1354
_SWIZZLE_MASK = {1: 0x5555, 2: 0x1354}


def unswizzle_phase_one(raw: np.ndarray, akey: int, bkey: int,
                        fmt: int) -> np.ndarray:
    """Undo the uncompressed formats' XOR-key pair swizzle (dcraw
    phase_one_load_raw): pairs are XORed with the keys, then a fixed
    format-dependent bit mask swaps between the two. A trailing odd
    word (never produced by real geometry) passes through untouched,
    mirroring dcraw's i += 2 loop bound."""
    if fmt == 0:
        return raw
    mask = np.uint16(_SWIZZLE_MASK.get(fmt, _SWIZZLE_MASK[2]))
    flat = raw.reshape(-1).astype(np.uint16).copy()
    npairs = flat.size // 2
    a = flat[0:npairs * 2:2] ^ np.uint16(akey)
    b = flat[1:npairs * 2:2] ^ np.uint16(bkey)
    flat[0:npairs * 2:2] = (a & mask) | (b & ~mask)
    flat[1:npairs * 2:2] = (b & mask) | (a & ~mask)
    return flat.reshape(raw.shape)


def swizzle_phase_one(img: np.ndarray, akey: int, bkey: int,
                      fmt: int) -> np.ndarray:
    """Inverse of unswizzle_phase_one (the operation is an involution up
    to the XOR order: swap the masked halves back, then XOR)."""
    if fmt == 0:
        return img
    mask = np.uint16(_SWIZZLE_MASK.get(fmt, _SWIZZLE_MASK[2]))
    flat = img.reshape(-1).astype(np.uint16).copy()
    npairs = flat.size // 2
    x = flat[0:npairs * 2:2]
    y = flat[1:npairs * 2:2]
    a = (x & mask) | (y & ~mask)
    b = (y & mask) | (x & ~mask)
    flat[0:npairs * 2:2] = a ^ np.uint16(akey)
    flat[1:npairs * 2:2] = b ^ np.uint16(bkey)
    return flat.reshape(img.shape)


def black_correct(pix: np.ndarray, fmt: int, black: int,
                  cblack: np.ndarray | None = None,
                  rblack: np.ndarray | None = None,
                  split_col: int = 0, split_row: int = 0) -> np.ndarray:
    """dcraw's in-loop correction for the compressed formats: shift left
    2 (format != 8), subtract the scalar black, add the signed per-row
    column-pair and per-column row-pair corrections (the pair index
    flips at split_col / split_row), keep only positive results."""
    height, width = pix.shape
    v = pix.astype(np.int32) << (2 if fmt != 8 else 0)
    v -= int(black)
    if cblack is not None:
        sel = (np.arange(width)[None, :] >= split_col).astype(np.int64)
        v += cblack.astype(np.int32)[np.arange(height)[:, None], sel]
    if rblack is not None:
        sel = (np.arange(height)[:, None] >= split_row).astype(np.int64)
        v += rblack.astype(np.int32)[np.arange(width)[None, :], sel]
    return np.where(v > 0, v & 0xFFFF, 0).astype(np.uint16)


# ROMM (Kodak ProPhoto, D50) linear RGB -> sRGB linear (public primaries;
# the dcraw romm_coeff constant set).
_ROMM_TO_SRGB = np.array(
    [[2.034193, -0.727420, -0.306766],
     [-0.228811, 1.231729, -0.002922],
     [-0.009127, -0.153724, 1.162851]], np.float64)


def romm_to_xyz_to_cam(romm_cam: np.ndarray) -> np.ndarray:
    """[4,3] xyz_to_cam from the file's camera->ROMM matrix (tag 0x106;
    dcraw's `romm_cam` in its `a_b` = b->a naming, composed WITHOUT
    inversion exactly as romm_coeff does): camera->sRGB =
    (ROMM->sRGB) @ (camera->ROMM), then camera->XYZ through the public
    sRGB primaries, inverted once into xyz_to_cam -- per-file
    colorimetry with no guessed per-body constants."""
    from .color import SRGB_D65_33  # the one sRGB->XYZ source of truth

    romm_cam = np.asarray(romm_cam, np.float64).reshape(3, 3)
    cam_to_xyz = SRGB_D65_33.astype(np.float64) @ _ROMM_TO_SRGB @ romm_cam
    xyz_to_cam = np.linalg.inv(cam_to_xyz).astype(np.float32)
    return np.concatenate([xyz_to_cam, np.zeros((1, 3), np.float32)], axis=0)


_ORIENT_BY_CODE = {0: Orientation.Normal, 1: Orientation.Rotate90,
                   2: Orientation.Rotate270, 3: Orientation.Rotate180}


def _parse_entries(buf: bytes, base: int):
    """The Raw-header directory at `base`: order mark, version+"waR"
    signature, directory offset, then 16-byte entries."""
    if base + 16 > len(buf):
        raise ValueError("IIQ: truncated header")
    order = struct.unpack_from("<I", buf, base)[0] & 0xFFFF
    if order == 0x4949:
        en = "<"
    elif order == 0x4D4D:
        en = ">"
    else:
        raise ValueError("IIQ: bad order mark")
    (sig,) = struct.unpack_from(en + "I", buf, base + 4)
    if (sig >> 8) != 0x526177:  # "Raw"
        raise ValueError("IIQ: missing Raw signature")
    (diroff,) = struct.unpack_from(en + "I", buf, base + 8)
    p = base + diroff
    if p + 8 > len(buf):
        raise ValueError("IIQ: directory offset out of range")
    (entries,) = struct.unpack_from(en + "I", buf, p)
    p += 8  # count + pad dword
    if entries > 4096 or p + 16 * entries > len(buf):
        raise ValueError("IIQ: implausible directory")
    out = {}
    for _ in range(entries):
        tag, typ, ln, data = struct.unpack_from(en + "4I", buf, p)
        out[tag] = (typ, ln, data, p + 12)
        p += 16
    return en, out


def _floats_at(buf: bytes, en: str, base: int, ent, n: int) -> np.ndarray:
    typ, ln, data, _pos = ent
    return np.array(struct.unpack_from(en + f"{n}f", buf, base + data),
                    np.float32)


def read_iiq(path: str) -> RawImage:
    """Phase One IIQ: 8-byte file magic, the "Raw" header at offset 8,
    uncompressed (keyed) and compressed payload formats."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:4] not in (b"IIII", b"MMMM"):
        raise ValueError("IIQ: not a Phase One file")
    base = 8
    en, tags = _parse_entries(buf, base)

    def scalar(tag, default=None):
        if tag not in tags:
            return default
        return int(tags[tag][2])

    raw_width = scalar(0x108, 0)
    raw_height = scalar(0x109, 0)
    if not raw_width or not raw_height or raw_width * raw_height > 500_000_000:
        raise ValueError("IIQ: missing/implausible sensor dimensions")
    fmt = scalar(0x10E, 0)
    data_off = scalar(0x10F)
    if data_off is None:
        raise ValueError("IIQ: missing raw data offset")
    data_off += base  # dcraw: data_offset = data + base
    if not 0 <= data_off <= len(buf):
        raise ValueError("IIQ: raw data offset out of range")

    if fmt < 3:
        need = raw_width * raw_height * 2
        if data_off + need > len(buf):
            raise ValueError("IIQ: truncated uncompressed payload")
        data = np.frombuffer(buf, en + "u2", count=raw_width * raw_height,
                             offset=data_off).reshape(raw_height, raw_width)
        akey = bkey = 0
        if fmt and 0x112 in tags:
            pos = tags[0x112][3]  # the key pair IS the data field
            akey, bkey = struct.unpack_from(en + "2H", buf, pos)
        data = unswizzle_phase_one(data.astype(np.uint16), akey, bkey, fmt)
        blacks = (scalar(0x21D, 0),) * 4
        white = 0xFFFF
    else:
        strip_off = scalar(0x21C)
        if strip_off is None:
            raise ValueError("IIQ: compressed payload without strip table")
        strip_off += base
        offsets = np.frombuffer(buf, en + "u4", count=raw_height,
                                offset=strip_off).astype(np.int64)
        pix = decode_phase_one(buf[data_off:], offsets, raw_width,
                               raw_height, fmt, en)
        cblack = rblack = None
        if 0x223 in tags:
            cblack = np.frombuffer(
                buf, en + "i2", count=raw_height * 2,
                offset=base + tags[0x223][2]).reshape(raw_height, 2)
        if 0x225 in tags:
            rblack = np.frombuffer(
                buf, en + "i2", count=raw_width * 2,
                offset=base + tags[0x225][2]).reshape(raw_width, 2)
        black = scalar(0x21D, 0)
        data = black_correct(pix, fmt, black, cblack, rblack,
                             scalar(0x222, 0), scalar(0x224, 0))
        blacks = (0,) * 4
        # dcraw: maximum = 0xfffc - ph1.black (the brightest value the
        # <<2 + black-subtracted chain can produce).
        white = max(0xFFFC - black, 1)

    left = scalar(0x10A, 0)
    top = scalar(0x10B, 0)
    vis_w = scalar(0x10C, raw_width - left)
    vis_h = scalar(0x10D, raw_height - top)
    if not (0 <= top and 0 <= left and top + vis_h <= raw_height
            and left + vis_w <= raw_width and vis_w > 0 and vis_h > 0):
        top, left, vis_w, vis_h = 0, 0, raw_width, raw_height
    crops = (top, raw_width - left - vis_w, raw_height - top - vis_h, left)

    wb = (float("nan"),) * 4
    if 0x107 in tags:
        mul = _floats_at(buf, en, base, tags[0x107], 3)
        if np.all(np.isfinite(mul)) and mul[1] > 0:
            wb = (float(mul[0] / mul[1]), 1.0, float(mul[2] / mul[1]),
                  float("nan"))

    model = ""
    if 0x301 in tags:
        raw_s = buf[base + tags[0x301][2]:base + tags[0x301][2] + 64]
        model = raw_s.split(b"\0", 1)[0].decode("ascii", "replace").strip()

    if 0x106 in tags:
        xyz_to_cam = romm_to_xyz_to_cam(
            _floats_at(buf, en, base, tags[0x106], 9))
    else:
        xyz_to_cam = xyz_to_cam_for("Phase One", model)

    orient = _ORIENT_BY_CODE[scalar(0x100, 0) & 3]
    return RawImage(
        width=raw_width, height=raw_height, cpp=1, crops=crops,
        blacklevels=blacks, whitelevels=(white,) * 4,
        wb_coeffs=wb, xyz_to_cam=xyz_to_cam, orientation=orient,
        cfa=CFA("RGGB"), data=data, make="Phase One", model=model)
