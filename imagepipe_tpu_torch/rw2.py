"""Panasonic RW2: container reader + the classic 12-bit codec.

The reference reaches Panasonic bodies through rawloader at
the reference's src/pipeline.rs:264. RW2 files are TIFF containers with
vendor magic 0x55 whose IFD0 carries Panasonic's private tags:

  0x0002/0x0003  SensorWidth/SensorHeight (the full decoded plane)
  0x0004..0x0007 sensor borders top/left/bottom/right (the visible crop)
  0x0009         CFA pattern code 1..4 -> RGGB/GRBG/GBRG/BGGR
  0x000A         BitsPerSample (12 for every classic body)
  0x001C..0x001E black level R/G/B (stored 15 below the effective level:
                 the public RawSpeed/rawloader convention adds 15)
  0x0011/0x0012  red/blue balance x256 (older bodies)
  0x0024..0x0026 WB red/green/blue levels (newer bodies)
  0x002D         RawFormat: absent/<=4 is the classic stream; 5/6/7 are
                 the newer packed/scaled-delta codecs (implemented
                 below); >=8 refuses by name
  0x0118         raw data offset

The classic codec (dcraw `panasonic_load_raw` + `pana_bits`, which
rawloader mirrors) is a variable-rate predictive stream read through a
peculiar addressing scheme: the file is split into 0x4000-byte sections,
each stored rotated by 0x2008 bytes (`load_flags`), and within a section
a descending 17-bit cursor reads 16-bit little-endian windows at byte
address `(vbits>>3) ^ 0x3ff0` -- i.e. 16-byte chunks consumed high byte
first, chunks in order. Pixels come in groups of 14 per row (groups
reset the predictor state; the 2-bit shift selector at in-group
positions 2/5/8/11 persists across groups and rows): per pixel an 8-bit
symbol either establishes a channel's 12-bit base value (symbol<<4 plus
4 explicit low bits), repeats the channel's previous value (symbol 0),
or steps it by `symbol << sh` from a rebased predictor.

The decoder prefers the native C++ implementation (native/rw2.cc, via
ctypes) and falls back to pure Python; the encoder exists for tests: it
greedily picks shift selectors and snaps unencodable values so
decode(encode(x)) round-trips pin every mechanism on arbitrary input.
Real-file cross-validation (tests/test_realfiles.py) is the external
check, exactly as for the Nikon/Olympus/Pentax codecs.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from . import native
from .cameras import xyz_to_cam_for
from .raw import CFA, Orientation, RawImage
from .tiff import TiffFile, exif_to_orientation

__all__ = ["read_rw2", "decode_panasonic", "encode_panasonic",
           "decode_panasonic_v5", "encode_panasonic_v5",
           "decode_panasonic_v6", "encode_panasonic_v6",
           "decode_panasonic_v7", "encode_panasonic_v7"]

_SECTION = 0x4000
_LOAD_FLAGS = 0x2008
_SPLIT = _SECTION - _LOAD_FLAGS  # bytes of the section stored first

_CFA_BY_CODE = {1: "RGGB", 2: "GRBG", 3: "GBRG", 4: "BGGR"}

# Shift selector: 2-bit code c -> sh = 4 >> (3 - c) -> {0, 0?}: codes
# 0..3 give shifts 0, 1, 2, 4 (code 0's `4 >> 3` is 0 too; the encoder
# only emits codes 1..3 for shifts 1/2/4 and code 0 for shift 0).
_SH_BY_CODE = (0, 1, 2, 4)
_CODE_BY_SH = {0: 0, 1: 1, 2: 2, 4: 3}


def _derotate(payload: bytes) -> bytes:
    """Undo the per-section 0x2008-byte rotation: each 0x4000 file
    section stores its logical tail first (dcraw reads `buf+load_flags`
    then `buf`)."""
    out = bytearray()
    for s in range(0, len(payload), _SECTION):
        sec = payload[s:s + _SECTION]
        if len(sec) < _SECTION:
            sec = sec + b"\0" * (_SECTION - len(sec))
        out += sec[_SPLIT:] + sec[:_SPLIT]
    return bytes(out)


class _PanaBits:
    """dcraw's pana_bits over the de-rotated logical stream: a 17-bit
    descending cursor; byte address `(vbits>>3) ^ 0x3ff0` within the
    current section."""

    def __init__(self, logical: bytes):
        self.data = logical
        self.off = 0
        self.vbits = 0
        self.buf = b""

    def __call__(self, n: int) -> int:
        if self.vbits == 0:
            if self.off >= len(self.data):
                raise ValueError("RW2: bitstream exhausted")
            sec = self.data[self.off:self.off + _SECTION]
            # dcraw's 2-byte window can touch buf[0x4000]; pad one zero.
            self.buf = sec + b"\0" * (_SECTION + 1 - len(sec))
            self.off += _SECTION
        elif (self.vbits & 127) and (self.vbits & 127) < n:
            # dcraw's descending-cursor addressing reads each field from
            # a 2-byte window inside one 16-byte chunk; a field crossing
            # a 128-bit chunk boundary would silently pull bits from the
            # wrong chunk. Well-formed streams never do this (full
            # 14-pixel groups cost exactly 128 bits and raw widths are
            # multiples of 14), so fail loud instead.
            raise ValueError("RW2: field straddles a 128-bit chunk "
                             "boundary (malformed stream)")
        self.vbits = (self.vbits - n) & 0x1FFFF
        byte = (self.vbits >> 3) ^ 0x3FF0
        word = self.buf[byte] | (self.buf[byte + 1] << 8)
        return (word >> (self.vbits & 7)) & ((1 << n) - 1)


def _decode_python(logical: bytes, width: int, height: int) -> np.ndarray:
    bits = _PanaBits(logical)
    out = np.zeros((height, width), np.uint16)
    sh = 0
    for row in range(height):
        pred = [0, 0]
        nonz = [0, 0]
        for col in range(width):
            i = col % 14
            ch = i & 1
            if i == 0:
                pred = [0, 0]
                nonz = [0, 0]
            if i % 3 == 2:
                sh = 4 >> (3 - bits(2))
            if nonz[ch]:
                j = bits(8)
                if j:
                    p = pred[ch] - (0x80 << sh)
                    if p < 0 or sh == 4:
                        p = pred[ch] & ~(-1 << sh)
                    pred[ch] = p + (j << sh)
            else:
                nonz[ch] = bits(8)
                if nonz[ch] or i > 11:
                    pred[ch] = (nonz[ch] << 4) | bits(4)
            out[row, col] = pred[ch] & 0xFFFF
    return out


def _decode_native(logical: bytes, width: int, height: int) -> np.ndarray:
    lib = native._lib
    fn = lib.rw2_decode
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_uint16)]
    out = np.empty((height, width), np.uint16)
    rc = fn(logical, len(logical), width, height,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
    if rc != 0:
        raise ValueError("RW2: bitstream exhausted")
    return out


def decode_panasonic(payload: bytes, width: int, height: int) -> np.ndarray:
    """Decode a classic Panasonic-compressed payload (file-order bytes,
    rotation included) to a (height, width) u16 sensor plane."""
    logical = _derotate(bytes(payload))
    if native.have_native() and hasattr(native._lib, "rw2_decode"):
        return _decode_native(logical, width, height)
    return _decode_python(logical, width, height)


class _PanaBitsWriter:
    """Mirror of _PanaBits for the test encoder: places bits at the
    exact addresses the reader consumes, emits rotated file sections."""

    def __init__(self):
        self.sections: list[bytearray] = []
        self.buf: bytearray | None = None
        self.vbits = 0

    def put(self, n: int, v: int) -> None:
        if self.vbits == 0:
            self.buf = bytearray(_SECTION + 1)
            self.sections.append(self.buf)
            self.vbits = 0x20000
        if (self.vbits & 127) and (self.vbits & 127) < n:
            raise ValueError("RW2 encoder: field would straddle a "
                             "128-bit chunk boundary (group invariant "
                             "broken)")
        self.vbits = (self.vbits - n) & 0x1FFFF
        byte = (self.vbits >> 3) ^ 0x3FF0
        word = (v & ((1 << n) - 1)) << (self.vbits & 7)
        self.buf[byte] |= word & 0xFF
        self.buf[byte + 1] |= (word >> 8) & 0xFF

    def file_bytes(self) -> bytes:
        out = bytearray()
        for sec in self.sections:
            # Inverse of _derotate: the file stores the logical tail
            # (from _LOAD_FLAGS) first, then the logical head.
            logical = sec[:_SECTION]
            out += logical[_LOAD_FLAGS:] + logical[:_LOAD_FLAGS]
        return bytes(out)


def encode_panasonic(img: np.ndarray,
                     snap: bool = False) -> bytes | tuple[bytes, np.ndarray]:
    """Encode a u16 sensor plane (< 4096) as a classic Panasonic stream.

    The scheme cannot represent every pixel sequence (a channel's first
    value in a group must be 0 or >= 16 except at positions 12/13, and
    steps are `j << sh` from a rebased predictor). With snap=False,
    unencodable values raise; with snap=True they are snapped to the
    nearest encodable value and the (stream, snapped_image) pair is
    returned -- decode(stream) == snapped_image exactly.
    """
    img = np.asarray(img)
    if img.ndim != 2:
        raise ValueError("expected a 2-D sensor plane")
    if img.max(initial=0) > 4095:
        raise ValueError("classic RW2 stream is 12-bit (values < 4096)")
    height, width = img.shape
    if width % 14:
        # Rows must stay 128-bit chunk-aligned (each full group costs
        # exactly 128 bits): a partial tail group would make later
        # fields straddle the 16-byte chunks dcraw's descending-cursor
        # addressing assumes, corrupting the stream. Real Panasonic v4
        # raw widths are multiples of 14 for exactly this reason.
        raise ValueError("classic RW2 width must be a multiple of 14")
    w = _PanaBitsWriter()
    snapped = img.astype(np.uint16).copy()
    sh = 0

    def reachable(value, pred_ch, nonz_ch, i, cur_sh):
        """(encodable?, nearest encodable value, symbol) for one pixel
        under current channel state and shift."""
        if nonz_ch:
            if value == pred_ch:
                return True, value, 0
            p = pred_ch - (0x80 << cur_sh)
            if p < 0 or cur_sh == 4:
                p = pred_ch & ~(-1 << cur_sh)
            j = max(1, min(255, (value - p) >> cur_sh))
            cand = [p + (j << cur_sh)]
            if j < 255:
                cand.append(p + ((j + 1) << cur_sh))
            cand.append(pred_ch)  # symbol 0 keeps the old value
            best = min(cand, key=lambda c: abs(c - value))
            if best == pred_ch:
                return best == value, best, 0
            jj = (best - p) >> cur_sh
            return best == value, best, jj
        # First symbol of this channel in the group: always establish a
        # 12-bit value >= 16 so nonz becomes nonzero and every full
        # group costs exactly 128 bits (the section-alignment invariant
        # real streams keep; sensor data sits above black ~143 anyway).
        if i > 11:
            best = min(max(int(value), 0), 4095)
            return best == value, best, best >> 4
        if value < 16:
            return False, 16, 1
        return True, int(value), int(value) >> 4

    for row in range(height):
        pred = [0, 0]
        nonz = [0, 0]
        col = 0
        while col < width:
            i = col % 14
            ch = i & 1
            if i == 0:
                pred = [0, 0]
                nonz = [0, 0]
            if i % 3 == 2:
                # Choose the shift for this selector's span (this pixel
                # and the next two) minimizing snap error.
                span = [(c, c % 14 & 1) for c in range(col, min(col + 3, width))
                        if c % 14 != 0 or c == col]
                best_sh, best_err = sh, None
                for cand_sh in (0, 1, 2, 4):
                    err = 0
                    p2, n2 = list(pred), list(nonz)
                    for c2, ch2 in span:
                        v2 = int(snapped[row, c2])
                        ok, near, sym = reachable(v2, p2[ch2], n2[ch2],
                                                  c2 % 14, cand_sh)
                        err += abs(near - v2)
                        if n2[ch2]:
                            if sym:
                                p2[ch2] = near
                        else:
                            n2[ch2] = sym
                            p2[ch2] = near
                    if best_err is None or err < best_err:
                        best_err, best_sh = err, cand_sh
                sh = best_sh
                w.put(2, _CODE_BY_SH[sh])
            v = int(snapped[row, col])
            ok, near, sym = reachable(v, pred[ch], nonz[ch], i, sh)
            if not ok:
                if not snap:
                    raise ValueError(
                        f"value {v} not encodable at ({row},{col}) "
                        "(use snap=True)")
                snapped[row, col] = near
                v = near
            if nonz[ch]:
                w.put(8, sym)
                if sym:
                    pred[ch] = v
            else:
                w.put(8, v >> 4)
                w.put(4, v & 15)
                pred[ch] = v
                nonz[ch] = v >> 4
            col += 1
    blob = w.file_bytes()
    return (blob, snapped) if snap else blob


# ---------------------------------------------------------------------------
# RawFormat 5 (14/12-bit packed sections), 6 (scaled-delta pages) and
# 7 ("pana8" packed blocks) -- the codecs every Panasonic body since ~2017
# writes. Bitstream semantics follow the public dcraw/LibRaw/RawSpeed
# reverse engineering (LibRaw pana_cs6_page_decoder/panasonicC6_load_raw,
# panasonicC7_load_raw; RawSpeed PanasonicV5Decompressor), re-implemented
# from the documented formats -- NOT copied code. As with the Fuji codec,
# the canonical encoders below make decode(encode(x)) round-trips pin every
# mechanism, python<->native differential fuzz pins the two decoders to
# each other, and real-file validation (tests/test_realfiles.py) is the
# external check confirming the recalled bit layouts on camera bytes.
# ---------------------------------------------------------------------------

def _unpack_lsb_packets(packets: np.ndarray, bps: int) -> np.ndarray:
    """Unpack 16-byte packets of continuous LSB-first `bps`-bit fields:
    (N, 16) u8 -> (N, 128 // bps) u16. Pad bits at the end of each packet
    (8 for bps=12, 2 for bps=14) are ignored."""
    ppp = 128 // bps
    bits = np.unpackbits(packets, axis=1, bitorder="little")
    out = np.zeros((len(packets), ppp), np.uint16)
    for j in range(bps):
        out |= (bits[:, j::bps][:, :ppp].astype(np.uint16)) << j
    return out


def _pack_lsb_packets(vals: np.ndarray, bps: int) -> bytes:
    """Inverse of _unpack_lsb_packets: (N, 128//bps) -> (N*16,) bytes."""
    ppp = 128 // bps
    vals = np.asarray(vals, np.uint16).reshape(-1, ppp)
    bits = np.zeros((len(vals), 128), np.uint8)
    for j in range(bps):
        bits[:, j:ppp * bps:bps] = (vals >> j) & 1
    return np.packbits(bits, axis=1, bitorder="little").tobytes()


def decode_panasonic_v5(payload: bytes, width: int, height: int,
                        bits: int = 14) -> np.ndarray:
    """RawFormat 5: the same 0x4000-byte section rotation as the classic
    stream, but each section is 1024 plain 16-byte packets of LSB-first
    `bits`-bit pixels (9 per packet at 14 bits, 10 at 12), streaming
    row-major across the whole frame with no per-row alignment."""
    if bits not in (12, 14):
        raise ValueError(f"RW2 v5: unsupported bit depth {bits}")
    ppp = 128 // bits
    npix = width * height
    npackets = -(-npix // ppp)
    # Length check BEFORE derotation: _derotate zero-pads partial
    # sections, which would turn a truncated payload into silent zero
    # pixels instead of the fail-loud contract.
    if len(payload) < npackets * 16:
        raise ValueError("RW2 v5: bitstream exhausted")
    logical = _derotate(bytes(payload))
    if native.have_native() and hasattr(native._lib, "rw2_decode_v5"):
        return _decode_native_wh(native._lib.rw2_decode_v5, logical,
                                 width, height, bits)
    packets = np.frombuffer(logical, np.uint8,
                            count=npackets * 16).reshape(-1, 16)
    pix = _unpack_lsb_packets(packets, bits).ravel()[:npix]
    return pix.reshape(height, width).copy()


def encode_panasonic_v5(img: np.ndarray, bits: int = 14) -> bytes:
    """Exact (lossless) encoder for RawFormat-5 payloads: plain packing,
    every `bits`-bit value is representable."""
    img = np.asarray(img)
    if img.ndim != 2:
        raise ValueError("expected a 2-D sensor plane")
    if img.max(initial=0) >= (1 << bits):
        raise ValueError(f"RW2 v5: values must be < 2^{bits}")
    ppp = 128 // bits
    flat = img.astype(np.uint16).ravel()
    pad = (-len(flat)) % ppp
    flat = np.concatenate([flat, np.zeros(pad, np.uint16)])
    logical = bytearray(_pack_lsb_packets(flat, bits))
    # Pad to whole 0x4000 sections, then apply the per-section rotation
    # (file stores the logical tail from _LOAD_FLAGS first).
    logical += b"\0" * ((-len(logical)) % _SECTION)
    out = bytearray()
    for s in range(0, len(logical), _SECTION):
        sec = logical[s:s + _SECTION]
        out += sec[_LOAD_FLAGS:] + sec[:_LOAD_FLAGS]
    return bytes(out)


# RawFormat-6 page layouts: each 16-byte page is consumed from its LAST
# byte backwards as a big-endian field sequence. 14-bit: two 14-bit
# absolute pixels + three [2-bit scale selector + three 10-bit values]
# groups, 4 pad bits (11 pixels/page). 12-bit: two 12-bit absolutes +
# FOUR [2-bit selector + three 8-bit values] groups filling all 128
# bits (14 pixels/page); the reconstruction is the same scaled-delta
# recurrence with the selector base starting at 0x80 instead of 0x200
# (so the absolute-coarse rebase threshold is 0x800, not 0x2000).
_V6_BIAS = 0xF  # the codec's built-in black bias, subtracted on output


class _V6Layout:
    """The per-bit-depth page geometry, with the pixel/selector field
    maps derived from the field sequence."""

    def __init__(self, bits: int):
        if bits == 14:
            self.fields = (14, 14) + (2, 10, 10, 10) * 3
            self.base0, self.thresh = 0x200, 0x2000
        elif bits == 12:
            self.fields = (12, 12) + (2, 8, 8, 8) * 4
            self.base0, self.thresh = 0x80, 0x800
        else:
            raise ValueError(f"RW2 v6: unsupported bit depth {bits}")
        self.bits = bits
        self.maxval = (1 << bits) - 1
        self.emax = (1 << (bits - 4)) - 1  # delta-field capacity (10/8 bit)
        pix_field, sel_field = [], {}
        for k, nb in enumerate(self.fields):
            if nb == 2:
                sel_field[len(pix_field)] = k
            else:
                pix_field.append(k)
        self.ppb = len(pix_field)  # pixels per 16-byte page
        self.pix_field = tuple(pix_field)
        self.sel_field = sel_field


_V6_LAYOUTS = {14: _V6Layout(14), 12: _V6Layout(12)}


def _v6_parse_pages(pages: np.ndarray, lay: _V6Layout) -> np.ndarray:
    """(N, 16) u8 -> (N, nfields) int32 field values."""
    rev = pages[:, ::-1].astype(np.uint32)
    out = np.empty((len(pages), len(lay.fields)), np.int32)
    bitpos = 0
    for k, nb in enumerate(lay.fields):
        vals = np.zeros(len(pages), np.uint32)
        for b in range(nb):
            bit = bitpos + b
            vals = (vals << 1) | ((rev[:, bit >> 3] >> (7 - (bit & 7))) & 1)
        out[:, k] = vals
        bitpos += nb
    return out


def _v6_emit_pages(fields: np.ndarray, lay: _V6Layout) -> bytes:
    """(N, nfields) -> (N*16,) bytes; inverse of _v6_parse_pages."""
    n = len(fields)
    rev = np.zeros((n, 16), np.uint8)
    bitpos = 0
    for k, nb in enumerate(lay.fields):
        v = fields[:, k].astype(np.uint32)
        for b in range(nb):
            bit = bitpos + b
            rev[:, bit >> 3] |= (((v >> (nb - 1 - b)) & 1)
                                 << (7 - (bit & 7))).astype(np.uint8)
        bitpos += nb
    return rev[:, ::-1].tobytes()


def _v6_reconstruct(fields: np.ndarray, lay: _V6Layout) -> np.ndarray:
    """Run the per-page scaled-delta reconstruction, vectorized across
    pages (state resets every page): (N, nfields) fields -> (N, ppb)."""
    n = len(fields)
    f = fields.astype(np.int64)
    oddeven = np.zeros((n, 2), np.int64)
    nonzero = np.zeros((n, 2), np.int64)
    pmul = np.zeros(n, np.int64)
    pbase = np.zeros(n, np.int64)
    out = np.empty((n, lay.ppb), np.uint16)
    for pix in range(lay.ppb):
        p = pix & 1
        if pix % 3 == 2:
            sel = f[:, lay.sel_field[pix]]
            sel = np.where(sel == 3, 4, sel)
            pbase = np.int64(lay.base0) << sel
            pmul = np.int64(1) << sel
        e = f[:, lay.pix_field[pix]]
        has = oddeven[:, p] != 0
        # Scaled-delta branch: value = e*pmul (+ prev - pbase when the
        # previous same-parity value exceeds the rebase threshold and
        # the selector is not the absolute-coarse one, pbase >= thresh).
        add = np.where((pbase < lay.thresh) & (nonzero[:, p] > pbase),
                       nonzero[:, p] - pbase, 0)
        val_scaled = e * pmul + add
        # Establishment branch: raw value; zero repeats the last nonzero.
        val_raw = np.where(e != 0, e, nonzero[:, p])
        val = np.where(has, val_scaled, val_raw)
        nonzero[:, p] = np.where(has, val_scaled, val_raw)
        oddeven[:, p] = np.where(has, oddeven[:, p], e)
        # The published decoder clamps both ways: biased values below
        # 0xF floor at 0, and chains grown past the pixel mask saturate
        # at maxval (possible in a crafted stream via repeated max
        # deltas; real sensors stay in range).
        out[:, pix] = np.minimum(np.maximum(val - _V6_BIAS, 0),
                                 lay.maxval).astype(np.uint16)
    return out


def decode_panasonic_v6(payload: bytes, width: int, height: int,
                        bits: int = 14) -> np.ndarray:
    """RawFormat 6: rows of 16-byte pages (11 pixels each at 14 bits,
    14 at 12). No section rotation. Trailing width % ppb pixels (none
    on real sensors) are left zero, mirroring the public decoder."""
    lay = _V6_LAYOUTS.get(bits)
    if lay is None:
        raise ValueError(f"RW2 v6: unsupported bit depth {bits}")
    blocks = width // lay.ppb
    bpr = blocks * 16
    if len(payload) < bpr * height:
        raise ValueError("RW2 v6: bitstream exhausted")
    if native.have_native() and hasattr(native._lib, "rw2_decode_v6"):
        return _decode_native_wh(native._lib.rw2_decode_v6,
                                 bytes(payload), width, height, bits)
    pages = np.frombuffer(payload, np.uint8,
                          count=bpr * height).reshape(-1, 16)
    pix = _v6_reconstruct(_v6_parse_pages(pages, lay), lay)
    out = np.zeros((height, width), np.uint16)
    out[:, :blocks * lay.ppb] = pix.reshape(height, blocks * lay.ppb)
    return out


def encode_panasonic_v6(img: np.ndarray, snap: bool = False,
                        bits: int = 14):
    """Encode a u16 plane (values <= 2^bits - 1 - bias) as a
    RawFormat-6 stream (14- or 12-bit page layout).

    Deltas quantize by the selector scale (1/2/4, or absolute/16), so not
    every sequence is representable: with snap=False unencodable values
    raise; with snap=True they snap to the nearest representable value
    and (stream, snapped) is returned with decode(stream) == snapped."""
    lay = _V6_LAYOUTS.get(bits)
    if lay is None:
        raise ValueError(f"RW2 v6: unsupported bit depth {bits}")
    img = np.asarray(img)
    if img.ndim != 2:
        raise ValueError("expected a 2-D sensor plane")
    height, width = img.shape
    ppb = lay.ppb
    if width % ppb:
        raise ValueError(f"RW2 v6 ({bits}-bit) width must be a multiple "
                         f"of {ppb}")
    snapped = np.minimum(img.astype(np.int64), lay.maxval - _V6_BIAS)
    if not snap and (snapped != img).any():
        raise ValueError(f"RW2 v6: values above {lay.maxval - _V6_BIAS} "
                         "(use snap=True)")
    fields = np.zeros((height * width // ppb, len(lay.fields)), np.int32)

    def dec_one(e, sel, nz):
        pbase = lay.base0 << sel
        pmul = 1 << sel
        if pbase < lay.thresh and nz > pbase:
            return e * pmul + nz - pbase
        return e * pmul

    page = 0
    for row in range(height):
        for blk in range(width // ppb):
            base = img[row, blk * ppb:blk * ppb + ppb].astype(
                np.int64) + _V6_BIAS
            tgt = np.minimum(base, lay.maxval)
            nonzero = [0, 0]
            sel = 0
            for pix in range(ppb):
                p = pix & 1
                te = int(tgt[pix])
                if pix < 2:
                    fields[page, lay.pix_field[pix]] = te
                    nonzero[p] = te
                    got = te
                else:
                    if pix % 3 == 2:
                        # Pick the selector minimizing snap error over
                        # its three-pixel span (simulated per candidate).
                        best_sel, best_err = 0, None
                        for cand in (0, 1, 2, 3):
                            s = 4 if cand == 3 else cand
                            nz2 = list(nonzero)
                            err = 0
                            for q in range(pix, min(pix + 3, ppb)):
                                t2 = int(tgt[q])
                                e2 = _v6_best_e(t2, s, nz2[q & 1], lay)
                                d2 = dec_one(e2, s, nz2[q & 1])
                                err += abs(d2 - t2)
                                nz2[q & 1] = d2
                            if best_err is None or err < best_err:
                                best_err, best_sel = err, cand
                        fields[page, lay.sel_field[pix]] = best_sel
                        sel = 4 if best_sel == 3 else best_sel
                    e = _v6_best_e(te, sel, nonzero[p], lay)
                    got = dec_one(e, sel, nonzero[p])
                    fields[page, lay.pix_field[pix]] = e
                    nonzero[p] = got
                if got != te:
                    if not snap:
                        raise ValueError(
                            f"value {te - _V6_BIAS} not encodable at "
                            f"({row},{blk * ppb + pix}) (use snap=True)")
                    snapped[row, blk * ppb + pix] = max(got - _V6_BIAS, 0)
                else:
                    snapped[row, blk * ppb + pix] = max(te - _V6_BIAS, 0)
            page += 1
    blob = _v6_emit_pages(fields, lay)
    if snap:
        return blob, snapped.astype(np.uint16)
    return blob


def _v6_best_e(target: int, sel: int, nz: int, lay: _V6Layout) -> int:
    """Best delta-field value reproducing `target` under selector state."""
    pbase = lay.base0 << sel
    pmul = 1 << sel
    off = nz - pbase if (pbase < lay.thresh and nz > pbase) else 0
    e = (target - off + pmul // 2) // pmul
    return int(min(max(e, 0), lay.emax))


def decode_panasonic_v7(payload: bytes, width: int, height: int,
                        bits: int = 14) -> np.ndarray:
    """RawFormat 7 ("pana8"): rows of plain 16-byte blocks of LSB-first
    packed pixels (9 per block at 14 bits, 10 at 12); each row starts on
    a block boundary; no section rotation."""
    if bits not in (12, 14):
        raise ValueError(f"RW2 v7: unsupported bit depth {bits}")
    ppp = 128 // bits
    if width % ppp:
        raise ValueError(f"RW2 v7: width must be a multiple of {ppp}")
    need = width // ppp * 16 * height
    if len(payload) < need:
        raise ValueError("RW2 v7: bitstream exhausted")
    if native.have_native() and hasattr(native._lib, "rw2_decode_v7"):
        return _decode_native_wh(native._lib.rw2_decode_v7,
                                 bytes(payload), width, height, bits)
    packets = np.frombuffer(payload, np.uint8, count=need).reshape(-1, 16)
    return _unpack_lsb_packets(packets, bits).reshape(height, width).copy()


def encode_panasonic_v7(img: np.ndarray, bits: int = 14) -> bytes:
    """Exact (lossless) encoder for RawFormat-7 payloads."""
    img = np.asarray(img)
    if img.ndim != 2:
        raise ValueError("expected a 2-D sensor plane")
    ppp = 128 // bits
    if img.shape[1] % ppp:
        raise ValueError(f"RW2 v7: width must be a multiple of {ppp}")
    if img.max(initial=0) >= (1 << bits):
        raise ValueError(f"RW2 v7: values must be < 2^{bits}")
    return _pack_lsb_packets(img.astype(np.uint16), bits)


def _decode_native_wh(fn, payload: bytes, width: int, height: int,
                      bits: int) -> np.ndarray:
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_uint16)]
    out = np.empty((height, width), np.uint16)
    rc = fn(payload, len(payload), width, height, bits,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
    if rc != 0:
        raise ValueError(f"RW2: native decode failed (rc={rc})")
    return out


def read_rw2(path: str) -> RawImage:
    """Panasonic RW2 (TIFF container, vendor magic 0x55): plain 16-bit
    LE payloads, the classic 12-bit compressed stream, and the newer
    RawFormat 5/6/7 codecs. RawFormat (tag 0x2D) >= 8 refuses with the
    version named."""
    with open(path, "rb") as f:
        buf = f.read()
    tf = TiffFile(buf, magics=(42, 85))
    ifd = tf.ifds[0]
    make = (tf.find1(271) or "").strip()
    model = (tf.find1(272) or "").strip()
    if 0x0118 not in ifd or 0x0002 not in ifd:
        raise ValueError("RW2: missing Panasonic raw tags")
    width = int(ifd.get1(0x0002) or 0)
    height = int(ifd.get1(0x0003) or 0)
    if not width or not height or width * height > 500_000_000:
        raise ValueError("RW2: missing/implausible sensor dimensions")
    bits = int(ifd.get1(0x000A, 12) or 12)
    if not 8 <= bits <= 16:
        raise ValueError(f"RW2: implausible BitsPerSample {bits}")
    rawformat = ifd.get1(0x002D)
    off = int(ifd.get1(0x0118) or 0)
    if not 0 <= off < len(buf):
        raise ValueError("RW2: raw data offset out of range")
    avail = len(buf) - off
    # Uncompressed discrimination is EXACT (rawloader's convention): the
    # plain-16-bit plane matches width*height*2 bytes precisely, by the
    # byte-count tag when present or by the data-to-EOF extent. A mere
    # `>=` would let trailing data after a compressed payload silently
    # reinterpret the bitstream as pixels.
    counts = ifd.get(0x0117) or []
    extent = sum(int(c) for c in counts) if counts else avail
    rf = int(rawformat) if rawformat is not None else 0
    if extent == width * height * 2 and avail >= extent:
        data = np.frombuffer(
            buf, "<u2", count=width * height, offset=off
        ).reshape(height, width).copy()
    elif rf >= 8:
        raise ValueError(
            f"RW2: RawFormat {rf} is newer than the known codecs "
            "(classic/5/6/7); convert to DNG")
    elif rf == 7:
        data = decode_panasonic_v7(buf[off:], width, height, bits)
    elif rf == 6:
        data = decode_panasonic_v6(buf[off:], width, height, bits)
    elif rf == 5:
        data = decode_panasonic_v5(buf[off:], width, height, bits)
    else:
        data = decode_panasonic(buf[off:], width, height)

    code = int(ifd.get1(0x0009, 0) or 0)
    cfa_name = _CFA_BY_CODE.get(code)
    if cfa_name is None:
        raise ValueError(f"RW2: unrecognized CFA pattern code {code}")

    # Visible-area crop from the sensor borders; RawImage.crops order is
    # [top, right, bottom, left].
    top = int(ifd.get1(0x0004, 0) or 0)
    left = int(ifd.get1(0x0005, 0) or 0)
    bottom = int(ifd.get1(0x0006, height) or height)
    right = int(ifd.get1(0x0007, width) or width)
    if not (0 <= top < bottom <= height and 0 <= left < right <= width):
        top, left, bottom, right = 0, 0, height, width
    crops = (top, width - right, height - bottom, left)

    # Black level tags store the effective level minus 15 (the public
    # RawSpeed/rawloader convention); stored R G B order.
    blk = [ifd.get1(t) for t in (0x001C, 0x001D, 0x001E)]
    if all(b is not None for b in blk):
        blacks = (int(blk[0]) + 15, int(blk[1]) + 15,
                  int(blk[2]) + 15, int(blk[1]) + 15)
    else:
        blacks = (0, 0, 0, 0)
    white = (1 << bits) - 1

    wb = (float("nan"),) * 4
    wbl = [ifd.get1(t) for t in (0x0024, 0x0025, 0x0026)]
    if all(v is not None for v in wbl) and float(wbl[1]) > 0:
        g = float(wbl[1])
        wb = (float(wbl[0]) / g, 1.0, float(wbl[2]) / g, float("nan"))
    else:
        red = ifd.get1(0x0011)
        blue = ifd.get1(0x0012)
        if red and blue and float(red) > 0 and float(blue) > 0:
            wb = (float(red) / 256.0, 1.0, float(blue) / 256.0,
                  float("nan"))

    orient = Orientation.Normal
    o = tf.find1(274)
    if o:
        got = exif_to_orientation(int(o))
        if got is not None:
            orient = got
    return RawImage(
        width=width, height=height, cpp=1, crops=crops,
        blacklevels=blacks, whitelevels=(white,) * 4,
        wb_coeffs=wb, xyz_to_cam=xyz_to_cam_for(make, model),
        orientation=orient, cfa=CFA(cfa_name), data=data,
        make=make, model=model)
