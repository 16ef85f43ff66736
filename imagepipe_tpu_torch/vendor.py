"""Vendor camera RAW readers: NEF (Nikon), CR2 (Canon), ARW (Sony).

The reference develops these through the rawloader crate (hundreds of
bodies; the reference's src/pipeline.rs:264). All three are TIFF-EP
containers, so they share tiff.py's hardened walker and differ only in
where the sensor plane, levels, white balance, and CFA live:

  NEF: raw SubIFD (CFA photometric), 12/14-bit big-endian packed, 16-bit,
       or compression 34713 (the modern default: Huffman predictive stream,
       decoded by nikon.py with the maker-note 0x0096 linearization);
       WB from the Nikon maker note (embedded TIFF, tag 0x000C rationals).
  CR2: raw IFD with Compression=6 (ITU-T81 lossless JPEG, our lj92 codec)
       cut into vertical slices (tag 0xC640); WB from the Canon maker note
       ColorData block (tag 0x4001); crops/black from SensorInfo (0x00E0).
  ARW: raw SubIFD, 16-bit little-endian, 12-bit packed, lossless JPEG, or
       ARW2 cRAW (compression 32767, 16-byte delta blocks + SR2 tone
       curve); WB/black/white from Sony tags (0x7313/0x7310/0x787F).

Colorimetric matrices come from the per-model registry (cameras.py).
"""

from __future__ import annotations

import struct

import numpy as np

from . import native
from .cameras import xyz_to_cam_for
from .raw import CFA, Orientation, RawImage
from .tiff import (TiffFile, Ifd, exif_to_orientation,
                   T_WIDTH, T_LENGTH, T_BITS, T_COMPRESSION, T_PHOTOMETRIC,
                   T_MAKE, T_MODEL, T_STRIP_OFFSETS, T_ORIENTATION,
                   T_ROWS_PER_STRIP, T_STRIP_BYTECOUNTS, T_CFA_REPEAT,
                   T_CFA_PATTERN, T_MAKERNOTE)

__all__ = ["read_nef", "read_cr2", "read_arw", "read_orf", "read_pef",
           "read_tiffep", "register_vendor_levels", "register_orf_pattern"]

_CFA_LETTERS = "RGBE"


def _cfa_from_ifd(ifd: Ifd) -> CFA:
    if ifd.get1(T_PHOTOMETRIC) != 32803:
        return CFA("")
    ph, pw = ifd.get(T_CFA_REPEAT, [2, 2])
    pat = ifd.get(T_CFA_PATTERN, [0, 1, 1, 2])
    if len(pat) < ph * pw or any(not 0 <= int(v) <= 3 for v in pat[: ph * pw]):
        raise ValueError("malformed CFAPattern tag")
    return CFA("".join(_CFA_LETTERS[v] for v in pat[: ph * pw]),
               height=int(ph), width=int(pw))


def _raw_cfa_ifd(tf: TiffFile) -> Ifd:
    """The IFD holding the mosaic plane (CFA photometric, largest)."""
    cands = [e for e in tf.ifds if e.get1(T_PHOTOMETRIC) == 32803]
    if not cands:
        raise ValueError("no CFA raw IFD in container")
    return max(cands, key=lambda e: (e.get1(T_WIDTH, 0) or 0) * (e.get1(T_LENGTH, 0) or 0))


def _read_strips(tf: TiffFile, ifd: Ifd, height: int, width: int,
                 bits: int, packing: str) -> np.ndarray:
    offsets = ifd.get(T_STRIP_OFFSETS)
    counts = ifd.get(T_STRIP_BYTECOUNTS)
    if not offsets or not counts:
        raise ValueError("raw IFD missing strip layout")
    rows_per_strip = ifd.get1(T_ROWS_PER_STRIP, height)
    rows = []
    for si, (off, cnt) in enumerate(zip(offsets, counts)):
        nrows = min(rows_per_strip, height - si * rows_per_strip)
        if nrows <= 0:
            break
        npix = nrows * width
        tf._check(off, cnt, "strip data")
        chunk = np.frombuffer(tf.buf, np.uint8, cnt, off)
        if bits == 16:
            need = npix * 2
            if cnt < need:
                raise ValueError("truncated 16-bit strip")
            if packing == "le":
                vals = np.frombuffer(chunk[:need].tobytes(), "<u2").astype(np.uint16)
            else:
                vals = native.swap_16be(chunk, npix)
        elif bits == 12:
            # The native unpackers take no source length and read the full
            # packed extent -- validate it against the strip byte count.
            if cnt < (npix + 1) // 2 * 3:
                raise ValueError("truncated 12-bit strip")
            vals = (native.unpack_12le(chunk, npix) if packing == "le"
                    else native.unpack_12be(chunk, npix))
        elif bits == 14:
            if packing == "le":
                raise ValueError("14-bit little-endian packing unsupported")
            if cnt < (npix + 3) // 4 * 7:
                raise ValueError("truncated 14-bit strip")
            vals = native.unpack_14be(chunk, npix)
        else:
            raise ValueError(f"unsupported BitsPerSample {bits}")
        rows.append(vals.reshape(nrows, width))
    data = np.concatenate(rows, axis=0)
    if data.shape != (height, width):
        raise ValueError(f"strip payload {data.shape} != {(height, width)}")
    return data


def _orientation(tf: TiffFile) -> Orientation:
    return exif_to_orientation(tf.find1(T_ORIENTATION, 1))


def _make_model(tf: TiffFile) -> tuple[str, str]:
    return tf.find1(T_MAKE, "") or "", tf.find1(T_MODEL, "") or ""


# ---------------------------------------------------------------------------
# NEF (Nikon)
# ---------------------------------------------------------------------------


def _nikon_makernote_tiff(tf: TiffFile):
    """Nikon maker notes embed a full TIFF stream at offset 10
    ("Nikon\\0" + version, then II/MM header; offsets relative to it)."""
    blob = tf.makernote()
    if blob is None or not blob.startswith(b"Nikon\0"):
        return None
    try:
        return TiffFile(blob, base=10)
    except ValueError:
        return None


def read_nef(path: str) -> RawImage:
    with open(path, "rb") as f:
        buf = f.read()
    tf = TiffFile(buf)
    make, model = _make_model(tf)
    if "NIKON" not in make.upper():
        raise ValueError("not a Nikon NEF")

    ifd = _raw_cfa_ifd(tf)
    width = ifd.get1(T_WIDTH)
    height = ifd.get1(T_LENGTH)
    if not width or not height or width * height > 500_000_000:
        raise ValueError("NEF: missing/implausible raw dimensions")
    bits = ifd.get1(T_BITS, 14)
    compression = ifd.get1(T_COMPRESSION, 1)

    wb = (float("nan"),) * 4
    black = 0
    mn = _nikon_makernote_tiff(tf)
    if mn is not None:
        # 0x000C WB RB levels: rationals ordered R, B, G1, G2.
        rb = mn.find(0x000C)
        # Validate green too: a zero green would turn into infinite WB
        # multipliers downstream (normalize divides by the green).
        if rb and len(rb) >= 4 and all(v > 0 for v in rb[:3]):
            wb = (float(rb[0]), float(rb[2]), float(rb[1]), float("nan"))
        bl = mn.find(0x003D)  # per-channel black level (newer bodies)
        if bl:
            black = int(round(sum(bl[:4]) / len(bl[:4])))

    white = (1 << bits) - 1
    if compression == 34713:
        # Lossless/lossy-compressed NEF (the modern default): Huffman
        # predictive stream + maker-note 0x0096 linearization metadata.
        from .nikon import decode_34713

        meta = mn.find_raw_bytes(0x0096) if mn is not None else None
        if meta is None:
            raise ValueError("NEF 34713: missing linearization metadata "
                             "(maker-note tag 0x0096)")
        offs = ifd.get(T_STRIP_OFFSETS)
        cnts = ifd.get(T_STRIP_BYTECOUNTS)
        if not offs or not cnts:
            raise ValueError("NEF 34713: raw IFD has no strip layout")
        # The Huffman stream is one logical payload; concatenate all strips
        # (files are single-strip in practice, but a split layout must not
        # silently truncate the bitstream).
        parts = []
        for off, cnt in zip(offs, cnts):
            off, cnt = int(off), int(cnt)
            tf._check(off, cnt, "NEF 34713 strip")
            parts.append(bytes(buf[off:off + cnt]))
        data, white = decode_34713(b"".join(parts), width, height,
                                   bits, meta)
    elif compression == 1:
        # Nikon packs 12/14-bit big-endian regardless of container
        # endianness.
        packing = "be" if bits in (12, 14) or tf.endian == ">" else "le"
        data = _read_strips(tf, ifd, height, width, bits, packing)
    else:
        raise ValueError(f"unsupported NEF compression {compression}")

    return RawImage(
        width=width, height=height, cpp=1, crops=(0, 0, 0, 0),
        blacklevels=(black,) * 4, whitelevels=(white,) * 4,
        wb_coeffs=wb, xyz_to_cam=xyz_to_cam_for(make, model),
        orientation=_orientation(tf), cfa=_cfa_from_ifd(ifd), data=data,
        make=make, model=model)


# ---------------------------------------------------------------------------
# CR2 (Canon)
# ---------------------------------------------------------------------------

# Canon ColorData (maker tag 0x4001) -> u16 index of WB_RGGBLevelsAsShot,
# keyed by the block's element count (the public ColorData version map).
_CANON_WB_INDEX = {
    582: 25,     # ColorData1: 20D, 350D
    653: 24,     # ColorData2: 1DmkII, 1DSmkII
    796: 63,     # ColorData3: 1DmkIIN, 30D, 400D
    674: 63, 692: 63, 702: 63, 1227: 63, 1250: 63,   # ColorData4
    1251: 63, 1337: 63, 1338: 63, 1346: 63,
    5120: 71,    # ColorData5 (PowerShot)
    1273: 63, 1275: 63,                              # ColorData6: 600D, 1200D
    1312: 63, 1313: 63, 1316: 63, 1506: 63,          # ColorData7: 5DmkIII..
    1560: 63, 1592: 63, 1353: 63, 1602: 63,          # ColorData8
    1820: 71, 1824: 71, 1816: 71,                    # ColorData9: R/R5/R6
    2024: 85, 3656: 85,                              # ColorData10
    3973: 105, 3778: 105,                            # ColorData11
}


def _canon_makernote_ifd(tf: TiffFile):
    """Canon maker notes are a bare IFD whose offsets are relative to the
    MAIN file, so parse it in place."""
    for ifd in tf.ifds:
        if 37500 in ifd.entries:
            typ, count, off = ifd.entries[37500]
            try:
                entries, _ = tf._read_ifd(off - tf.base)
                return Ifd(tf, entries, off)
            except ValueError:
                return None
    return None


def _unslice_cr2(flat: np.ndarray, height: int, slices) -> np.ndarray:
    """Reassemble the sensor frame from Canon's vertical slices: the LJ92
    stream fills slice 0's rows first, then slice 1, ... (tag 0xC640 =
    [n, w1, w2]: n slices of width w1 plus one of width w2)."""
    n, w1, w2 = int(slices[0]), int(slices[1]), int(slices[2])
    width = n * w1 + w2
    if flat.size != height * width:
        raise ValueError(f"CR2 slice layout mismatch: {flat.size} values vs "
                         f"{height}x{width}")
    out = np.empty((height, width), np.uint16)
    pos = 0
    for j in range(n + 1):
        w = w1 if j < n else w2
        if w == 0:
            continue
        out[:, j * w1: j * w1 + w] = flat[pos: pos + w * height].reshape(height, w)
        pos += w * height
    return out


def _canon_wb_from_makernote(mn) -> tuple:
    """WB from ColorData (makernote 0x4001); NaN quad when absent."""
    if mn is not None:
        cd = mn.get(0x4001)
        if cd:
            idx = _CANON_WB_INDEX.get(len(cd))
            if idx is not None and idx + 4 <= len(cd):
                r, g1, g2, b = (float(v) for v in cd[idx: idx + 4])
                if r > 0 and g1 > 0:
                    return (r, g1, b, float("nan"))
    return (float("nan"),) * 4


# Canon's YCbCr->camera-RGB fixed-point matrix for sRAW/mRAW (>>14), the
# reference chain's semantics (dcraw canon_sraw_load_raw's integer
# coefficients, consumed identically by rawloader's cr2 sraw path).
# PROVENANCE NOTE: the mechanism around it (subsampled SOF3 MCUs, the
# chained-Y predictor, linear chroma interpolation) is format-forced and
# pinned by the canonical encoder round-trips; these six constants and
# the 1<<(prec-1) chroma bias are the recalled-constant surface awaiting
# the first real sRAW file through the realfile harness
# (tests/test_realfiles.py), like fujic.py's B2 interpolation mask.
_SRAW_RGB = ((50, 22929), (-5640, -11751), (29040, -101))


def _chroma_upsample(p: np.ndarray, vs: int, hs: int, H: int, W: int):
    """Linear integer upsample of a chroma plane from the MCU grid to the
    luma grid ((a+b)>>1 midpoints, edge-replicated), then crop to HxW."""
    p = p.astype(np.int32)
    if vs == 2:
        up = np.empty((p.shape[0] * 2, p.shape[1]), np.int32)
        up[0::2] = p
        up[1:-1:2] = (p[:-1] + p[1:]) >> 1
        up[-1] = p[-1]
        p = up
    if hs == 2:
        up = np.empty((p.shape[0], p.shape[1] * 2), np.int32)
        up[:, 0::2] = p
        up[:, 1:-1:2] = (p[:, :-1] + p[:, 1:]) >> 1
        up[:, -1] = p[:, -1]
        p = up
    return p[:H, :W]


def _read_cr2_sraw(tf: TiffFile, payload: bytes, make: str,
                   model: str) -> RawImage:
    """sRAW/mRAW: subsampled YCbCr lossless JPEG -> demosaiced cpp=3
    camera RGB (develops through the engine's rgb mode, like LinearRaw
    DNGs). Sensor crops don't apply (the frame is already the active
    area at reduced resolution)."""
    from .lj92 import decode_sraw

    mcus, prec, hs, vs = decode_sraw(payload)
    if not 10 <= prec <= 16:
        raise ValueError(f"implausible sRAW SOF precision {prec}")
    clrs = hs * vs + 2
    rows = mcus.shape[0]
    n_mcu = mcus.shape[1] // clrs
    H, W = rows * vs, n_mcu * hs
    m3 = mcus.reshape(rows, n_mcu, clrs)
    Y = (m3[:, :, :hs * vs].reshape(rows, n_mcu, vs, hs)
         .transpose(0, 2, 1, 3).reshape(H, W).astype(np.int32))
    bias = 1 << (prec - 1)
    cb = _chroma_upsample(m3[:, :, hs * vs], vs, hs, H, W) - bias
    cr = _chroma_upsample(m3[:, :, hs * vs + 1], vs, hs, H, W) - bias
    maxv = (1 << prec) - 1
    chans = [Y + ((kb * cb + kr * cr) >> 14) for kb, kr in _SRAW_RGB]
    data = np.clip(np.stack(chans, axis=-1), 0, maxv).astype(np.uint16)
    return RawImage(
        width=W, height=H, cpp=3, crops=(0, 0, 0, 0),
        blacklevels=(0,) * 4, whitelevels=(maxv,) * 4,
        wb_coeffs=_canon_wb_from_makernote(_canon_makernote_ifd(tf)),
        xyz_to_cam=xyz_to_cam_for(make, model),
        orientation=_orientation(tf), cfa=CFA(""),
        data=data.reshape(H, W * 3), make=make, model=model)


def read_cr2(path: str) -> RawImage:
    with open(path, "rb") as f:
        buf = f.read()
    if len(buf) < 12 or buf[8:10] != b"CR":
        raise ValueError("not a CR2 (missing CR header)")
    tf = TiffFile(buf)
    make, model = _make_model(tf)

    # The RAW IFD is the one holding the lossless-JPEG strip (Compression 6).
    raw_ifds = [e for e in tf.ifds
                if e.get1(T_COMPRESSION) == 6 and T_STRIP_OFFSETS in e]
    if not raw_ifds:
        raise ValueError("no lossless-JPEG raw IFD in CR2")
    ifd = raw_ifds[-1]
    (off,) = ifd.get(T_STRIP_OFFSETS)[:1]
    (cnt,) = ifd.get(T_STRIP_BYTECOUNTS, [len(buf) - off])[:1]
    tf._check(off, cnt, "CR2 raw strip")

    from .lj92 import decode as lj92_decode, sof_precision

    payload = bytes(buf[off:off + cnt])
    # sRAW/mRAW files carry a subsampled 3-component YCbCr lossless-JPEG
    # frame (dcraw's canon_sraw_load_raw; rawloader's cr2 sraw path) — a
    # demosaiced colorimetric pipeline, not a mosaic.
    from .lj92 import sof_ncomp

    if sof_ncomp(payload) == 3:
        return _read_cr2_sraw(tf, payload, make, model)
    decoded = lj92_decode(payload)  # [h, w*ncomp]
    height = decoded.shape[0]
    slices = ifd.get(0xC640)
    if slices and len(slices) >= 3 and slices[0] > 0:
        data = _unslice_cr2(decoded.ravel(), height, slices)
    else:
        data = decoded
    width = data.shape[1]

    crops = (0, 0, 0, 0)
    black = 0
    mn = _canon_makernote_ifd(tf)
    wb = _canon_wb_from_makernote(mn)
    if mn is not None:
        si = mn.get(0x00E0)  # SensorInfo
        if si and len(si) >= 9:
            left, top, right, bottom = si[5], si[6], si[7], si[8]
            # right/bottom are inclusive last-active-pixel coordinates; a
            # file using the exclusive convention would otherwise produce a
            # negative crop from the width-1-right formula below.
            if 0 <= left < right < width and 0 <= top < bottom < height:
                crops = (top, width - 1 - right, height - 1 - bottom, left)
                if left >= 4:
                    # Black from the masked border (the reference chain's
                    # rawloader does the same for Canon).
                    black = int(round(float(np.mean(data[top:bottom, : left - 2]))))

    bits = sof_precision(payload)  # the SOF3 precision is authoritative
    if not 8 <= bits <= 16:
        raise ValueError(f"implausible CR2 SOF precision {bits}")
    return RawImage(
        width=width, height=height, cpp=1, crops=crops,
        blacklevels=(black,) * 4, whitelevels=((1 << bits) - 1,) * 4,
        wb_coeffs=wb, xyz_to_cam=xyz_to_cam_for(make, model),
        orientation=_orientation(tf), cfa=CFA("RGGB"), data=data,
        make=make, model=model)


# ---------------------------------------------------------------------------
# ARW (Sony)
# ---------------------------------------------------------------------------


def _sony_curve(bp) -> np.ndarray:
    """ARW2 tone curve: 4096-entry LUT from the four SR2 breakpoints in tag
    0x7010 (dcraw's sony curve: segment i of [0, b0..b3, 4095] steps by
    2^i; decoded 11-bit samples index it as curve[pix*2] >> 2). `bp` is
    the breakpoint list (plaintext tag or the decrypted SR2Private's)."""
    if not bp or len(bp) < 4:
        raise ValueError("ARW2: missing tone-curve breakpoints (tag 0x7010)")
    pts = [0] + [(int(v) >> 2) & 0xFFF for v in bp[:4]] + [4095]
    if pts != sorted(pts):
        raise ValueError("ARW2: non-monotone tone-curve breakpoints")
    curve = np.zeros(4096, np.uint32)
    for i in range(5):
        lo, hi = pts[i], pts[i + 1]
        n = hi - lo
        if n > 0:
            curve[lo + 1:hi + 1] = curve[lo] + (np.arange(1, n + 1,
                                                          dtype=np.uint32) << i)
    return curve


def _arw2_decode(payload: bytes, height: int, width: int,
                 curve: np.ndarray) -> np.ndarray:
    """Sony ARW2 (compression 32767) cRAW: each row is `width` bytes of
    16-byte blocks; a block packs 16 same-color pixels (every other column)
    as 11-bit max/min, their 4-bit positions, and 14 7-bit deltas scaled by
    a shift derived from max-min. Block pairs interleave even/odd columns
    over 32-column spans (dcraw sony_arw2_load_raw semantics)."""
    if width % 32:
        raise ValueError("ARW2: raw width must be a multiple of 32")
    need = height * width
    if len(payload) < need:
        raise ValueError("ARW2: truncated payload")
    b = np.frombuffer(payload, np.uint8, count=need).reshape(
        height, width // 16, 16).astype(np.uint32)

    val = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)
    vmax = val & 0x7FF
    vmin = (val >> 11) & 0x7FF
    imax = (val >> 22) & 0xF
    imin = (val >> 26) & 0xF
    diff = vmax - vmin
    sh = np.zeros_like(diff)
    for s in range(4):
        sh += (np.uint32(0x80) << s) <= diff

    pix = np.empty(b.shape[:2] + (16,), np.uint32)
    # Delta slot k (k-th position that is neither imax nor imin) sits at
    # bit 30 + 7k; the final slot's 7 bits fit inside byte 15.
    slot = np.zeros(b.shape[:2], np.uint32)
    for i in range(16):
        bit = 30 + 7 * slot
        # The read is speculative (ignored at max/min positions); slot can
        # already be 14 there, so clamp the offsets into the block.
        off = np.minimum(bit >> 3, 15)
        lo = np.take_along_axis(b, off[..., None], axis=-1)[..., 0]
        off1 = np.minimum(off + 1, 15)
        hi = np.take_along_axis(b, off1[..., None], axis=-1)[..., 0]
        hi = np.where(off + 1 > 15, 0, hi)
        d7 = ((lo | (hi << 8)) >> (bit & 7)) & 0x7F
        v = np.minimum(vmin + (d7 << sh), 0x7FF)
        is_max = imax == i
        is_min = (imin == i) & ~is_max          # dcraw checks imax first
        pix[..., i] = np.where(is_max, vmax, np.where(is_min, vmin, v))
        slot = slot + (~(is_max | is_min)).astype(np.uint32)

    out16 = (curve[(pix << 1).reshape(-1)] >> 2).astype(np.uint16)
    out16 = out16.reshape(height, width // 16, 16)
    # Block 2t fills even columns of span [32t, 32t+32), block 2t+1 the odd.
    res = np.empty((height, width), np.uint16)
    spans = out16.reshape(height, width // 32, 2, 16)
    res_v = res.reshape(height, width // 32, 16, 2)
    res_v[:, :, :, 0] = spans[:, :, 0, :]
    res_v[:, :, :, 1] = spans[:, :, 1, :]
    return res


def _sony_sr2_private(tf: TiffFile, buf: bytes):
    """Decrypt + parse the SR2Private metadata block: tag 0x7200 is the
    block's file offset, 0x7201 its length, 0x7221 the LFSR key (the
    same public sony_decrypt keystream as SRF). The decrypted bytes are
    an IFD whose value pointers are FILE-relative and land inside the
    block, so parsing works over the buffer with the block patched in
    place (dcraw's negative-base tmpfile trick, without the tmpfile).
    Returns {tag: values} or None."""
    off = tf.find1(0x7200)
    length = tf.find1(0x7201)
    key = tf.find1(0x7221)
    if not off or not length or key is None:
        return None
    off, length = int(off), int(length)
    if not (0 <= off and off + length <= len(buf) and 0 < length < 1 << 24):
        return None
    from .sony_srf import sony_crypt

    nwords = length // 4
    plain = sony_crypt(buf[off:off + nwords * 4], int(key))
    patched = buf[:off] + plain + buf[off + nwords * 4:]
    try:
        sub = object.__new__(TiffFile)
        sub.buf = patched
        sub.base = 0
        sub.endian = tf.endian
        sub.ifds = []
        entries, _ = sub._read_ifd(off)
        ifd = Ifd(sub, entries, off)
    except ValueError:
        return None
    out = {}
    for tag in (0x7010, 0x7303, 0x7310, 0x7312, 0x7313, 0x787F):
        v = ifd.get(tag)
        if v:
            out[tag] = v
    return out


def read_arw(path: str) -> RawImage:
    with open(path, "rb") as f:
        buf = f.read()
    tf = TiffFile(buf)
    make, model = _make_model(tf)
    if "SONY" not in make.upper():
        raise ValueError("not a Sony ARW")

    ifd = _raw_cfa_ifd(tf)
    width = ifd.get1(T_WIDTH)
    height = ifd.get1(T_LENGTH)
    if not width or not height or width * height > 500_000_000:
        raise ValueError("ARW: missing/implausible raw dimensions")
    bits = ifd.get1(T_BITS, 16)
    compression = ifd.get1(T_COMPRESSION, 1)
    arw2_white = None

    def strip0():
        offs = ifd.get(T_STRIP_OFFSETS)
        cnts = ifd.get(T_STRIP_BYTECOUNTS)
        if not offs or not cnts:
            raise ValueError("ARW: raw IFD has no strip layout "
                             "(tiled mosaics are not supported)")
        return int(offs[0]), int(cnts[0])

    # Sony calibration tags (searched across the IFD tree). Modern ARWs
    # carry them in plaintext; SR2 and early bodies hide them in the
    # LFSR-encrypted SR2Private block (tags 0x7200/0x7201/0x7221) --
    # decrypt it with the shared Sony keystream and search there too.
    sr2 = None

    def _find(tag):
        v = tf.find(tag)
        if v:
            return v
        nonlocal sr2
        if sr2 is None:
            sr2 = _sony_sr2_private(tf, buf) or {}
        return sr2.get(tag)

    if compression == 32767:
        off, cnt = strip0()
        tf._check(off, cnt, "ARW2 raw strip")
        # Curve breakpoints ride the encrypted block on early bodies.
        curve = _sony_curve(_find(0x7010))
        data = _arw2_decode(bytes(buf[off:off + cnt]), height, width, curve)
        arw2_white = int(curve[0xFFE] >> 2)
    elif compression == 7:
        from .lj92 import decode as lj92_decode

        off, cnt = strip0()
        tf._check(off, cnt, "ARW raw strip")
        data = lj92_decode(bytes(buf[off:off + cnt]))
        if data.shape[1] != width:
            data = data.reshape(height, width)
    elif compression == 1:
        off, cnt = strip0()
        if (cnt < width * height * 2
                and model.strip().upper() == "DSLR-A100"):
            # ARW v1: the A100 stamps compression 1 but the strip is the
            # Huffman DPCM stream (dcraw sony_arw_load_raw; see arw1.py
            # for the algorithm + provenance notes).
            from .arw1 import decode_arw1

            tf._check(off, cnt, "ARW1 raw strip")
            data = decode_arw1(bytes(buf[off:off + cnt]), width, height)
        else:
            data = _read_strips(tf, ifd, height, width, bits,
                                "le" if tf.endian == "<" else "be")
    else:
        raise ValueError(f"unsupported ARW compression {compression}")

    wb = (float("nan"),) * 4
    # As-shot RGGB (0x7313) first; auto-WB RGGB (0x7312) as fallback.
    rggb = _find(0x7313) or _find(0x7312)  # stored R G1 G2 B
    if rggb and len(rggb) >= 4 and rggb[0] > 0 and rggb[1] > 0:
        wb = (float(rggb[0]), float(rggb[1]), float(rggb[3]), float("nan"))
    else:
        # Only older bodies store G R B G2 (0x7303) -- looked up lazily
        # so the common case never touches the encrypted block for it.
        grbg = _find(0x7303)
        if grbg and len(grbg) >= 4 and grbg[0] > 0 and grbg[1] > 0:
            wb = (float(grbg[1]), float(grbg[0]), float(grbg[2]),
                  float("nan"))
    bl = _find(0x7310)
    if bl and len(bl) >= 4:
        # Stored R G1 G2 B (dcraw's c ^ (c >> 1)) -> repo order R G1 B G2,
        # kept per channel (averaging would tint shadows on bodies with
        # unequal channel blacks).
        blacks = (int(bl[0]), int(bl[1]), int(bl[3]), int(bl[2]))
    elif bl:
        blacks = (int(bl[0]),) * 4
    else:
        blacks = (0,) * 4
    wl = _find(0x787F)
    if wl:
        white = int(wl[0])
    elif arw2_white is not None:
        white = arw2_white          # top of the ARW2 tone curve
    else:
        white = (1 << bits) - 1

    return RawImage(
        width=width, height=height, cpp=1, crops=(0, 0, 0, 0),
        blacklevels=blacks, whitelevels=(white,) * 4,
        wb_coeffs=wb, xyz_to_cam=xyz_to_cam_for(make, model),
        orientation=_orientation(tf), cfa=_cfa_from_ifd(ifd), data=data,
        make=make, model=model)


# ---------------------------------------------------------------------------
# ORF (Olympus) and PEF (Pentax) — the uncompressed / plain-packed flavors.
# ---------------------------------------------------------------------------

# model (uppercased) -> (black, white) overrides for bodies whose files
# carry no level tags (same pattern as raf.raf_levels_for).
_VENDOR_LEVELS: dict[str, tuple[int, int]] = {}


def register_vendor_levels(model: str, black: int, white: int) -> None:
    _VENDOR_LEVELS[model.strip().upper()] = (int(black), int(white))


def _vendor_levels(model: str, bits: int) -> tuple[int, int]:
    return _VENDOR_LEVELS.get((model or "").strip().upper(),
                              (0, (1 << bits) - 1))


# model (uppercased) -> CFA for ORFs (their raw IFD carries no CFA tags).
_ORF_PATTERNS: dict[str, CFA] = {}


def register_orf_pattern(model: str, pattern: str) -> None:
    _ORF_PATTERNS[model.strip().upper()] = CFA(pattern)


def _olympus_makernote(tf: TiffFile):
    """The Olympus maker note as (Ifd, owner TiffFile-ish), or None.

    Two public header flavors: classic 'OLYMP\\0\\0\\0' (a bare IFD at
    note+8, FILE-relative offsets, container byte order) and newer
    'OLYMPUS\\0' + 'II'/'MM' + version (the IFD starts at note+12,
    offsets are NOTE-relative, own byte order)."""
    for ifd in tf.ifds:
        if 37500 not in ifd.entries:
            continue
        typ, count, off = ifd.entries[37500]
        head = bytes(tf.buf[off:off + 12])
        try:
            if head.startswith(b"OLYMP\0"):
                entries, _ = tf._read_ifd(off + 8 - tf.base)
                return Ifd(tf, entries, off), tf
            if head.startswith(b"OLYMPUS\0"):
                order = {b"II": "<", b"MM": ">"}.get(head[8:10])
                if order is None:
                    return None
                sub = object.__new__(TiffFile)
                sub.buf = tf.buf
                sub.base = off
                sub.endian = order
                sub.ifds = []
                entries, _ = sub._read_ifd(12)
                return Ifd(sub, entries, off), sub
        except ValueError:
            return None  # bounds-checked walk failed: ignore the note
    return None


def _olympus_imageprocessing(found):
    """The ImageProcessing sub-IFD (maker-note tag 0x2040) as an Ifd, or
    None. `found` is the (Ifd, owner) pair from _olympus_makernote (the
    note is parsed once and shared). The subdirectory rides either
    inline (UNDEFINED payload that IS the nested IFD) or as a
    note-relative offset value; the nested IFD's own value offsets keep
    the note's convention either way."""
    if found is None:
        return None
    mn, owner = found
    if 0x2040 not in mn.entries:
        return None
    typ, count, off = mn.entries[0x2040]
    try:
        if typ in (4, 13) and count == 1:
            (ptr,) = struct.unpack_from(owner.endian + "I", owner.buf, off)
            entries, _ = owner._read_ifd(ptr)
        else:
            entries, _ = owner._read_ifd(off - owner.base)
        return Ifd(owner, entries, off)
    except ValueError:
        return None


def _olympus_calibration(tf: TiffFile):
    """(wb, cam_to_srgb|None, blacks|None, valid_bits|None, crop|None)
    from the maker note. Classic notes carry WB in 0x1017/0x1018
    (red/blue balance x256); newer bodies put calibration in the
    ImageProcessing sub-IFD: 0x0100 WB R/B levels (x256), 0x0200 the
    3x3 camera->sRGB color matrix (signed, /256 -- the public
    dcraw/exiftool semantics; per-FILE colorimetry, no per-body
    registry), 0x0600 per-CFA-position black levels, 0x0611 valid bits,
    0x0612..0x0615 crop left/top/width/height."""
    wb = None
    cam2srgb = blacks = valid_bits = crop = None
    found = _olympus_makernote(tf)
    if found is not None:
        mn, _owner = found
        red = mn.get(0x1017)
        blue = mn.get(0x1018)
        if red and blue and float(red[0]) > 0 and float(blue[0]) > 0:
            wb = (float(red[0]) / 256.0, 1.0, float(blue[0]) / 256.0,
                  float("nan"))
    ip = _olympus_imageprocessing(found)
    if ip is not None:
        rb = ip.get(0x0100)
        if rb and len(rb) >= 2 and float(rb[0]) > 0 and float(rb[1]) > 0:
            wb = (float(rb[0]) / 256.0, 1.0, float(rb[1]) / 256.0,
                  float("nan"))
        cm = ip.get(0x0200)
        if cm and len(cm) >= 9:
            m = np.array([v - 65536 if v >= 32768 else v
                          for v in cm[:9]], np.float32).reshape(3, 3) / 256.0
            # Plausibility: rows of a camera->sRGB matrix sum near 1.
            if np.all(np.abs(m.sum(axis=1) - 1.0) < 0.25) and \
                    np.linalg.det(m.astype(np.float64)) > 1e-3:
                cam2srgb = m
        bl = ip.get(0x0600)
        if bl and len(bl) >= 4:
            # Stored per 2x2 CFA position (reading order); channel order
            # here follows the Pentax convention (R, G1, B, G2).
            blacks = (int(bl[0]), int(bl[1]), int(bl[3]), int(bl[2]))
        vb = ip.get(0x0611)
        if vb and 8 <= int(vb[0]) <= 16:
            valid_bits = int(vb[0])
        cl, ct = ip.get1(0x0612), ip.get1(0x0613)
        cw, ch = ip.get1(0x0614), ip.get1(0x0615)
        if None not in (cl, ct, cw, ch) and int(cw) > 0 and int(ch) > 0:
            crop = (int(cl), int(ct), int(cw), int(ch))
    return wb, cam2srgb, blacks, valid_bits, crop


def read_orf(path: str) -> RawImage:
    """Olympus ORF: a TIFF container with vendor magic ('RO'/'RS') whose
    raw IFD holds plain 16-bit, 12-bit-packed little-endian, or
    Olympus-compressed sensor data (the predictive bitstream every body
    since ~2004 writes; decoded by olympus.decode_olympus). The raw IFD
    carries no CFA tags; the pattern comes from the per-model registry
    (register_orf_pattern) -- refusing beats guessing a mosaic."""
    with open(path, "rb") as f:
        buf = f.read()
    tf = TiffFile(buf, magics=(42, 0x4F52, 0x5352))
    make, model = _make_model(tf)
    if "OLYMPUS" not in make.upper():
        raise ValueError("not an Olympus ORF")

    cands = [e for e in tf.ifds
             if T_STRIP_OFFSETS in e and (e.get1(T_WIDTH, 0) or 0) > 0]
    if not cands:
        raise ValueError("ORF: no raw IFD with strip data")
    ifd = max(cands, key=lambda e: (e.get1(T_WIDTH, 0) or 0)
              * (e.get1(T_LENGTH, 0) or 0))
    width = ifd.get1(T_WIDTH)
    height = ifd.get1(T_LENGTH)
    if not width or not height or width * height > 500_000_000:
        raise ValueError("ORF: missing/implausible raw dimensions")
    compression = ifd.get1(T_COMPRESSION, 1)
    if compression != 1:
        raise ValueError(f"ORF: unrecognized ORF compression tag "
                         f"{compression} (Olympus writes 1 even for its "
                         "compressed stream)")
    counts = ifd.get(T_STRIP_BYTECOUNTS) or []
    offsets = ifd.get(T_STRIP_OFFSETS) or []
    total = sum(int(c) for c in counts)
    npix = width * height
    rps = int(ifd.get1(T_ROWS_PER_STRIP, height) or height)
    packed_need = sum((min(rps, height - i * rps) * width + 1) // 2 * 3
                      for i in range((height + rps - 1) // rps))
    # STORAGE layout from the strip byte counts: >= 2 bytes/pixel = plain
    # 16-bit LE words (threshold, so padded/over-reported counts on
    # uncompressed files keep decoding); EXACTLY the packed extent = the
    # classic 12-bit stream (2 pixels in 3 bytes -- packed files carry no
    # padding, and a threshold here would swallow large compressed
    # streams); anything else is the Olympus-compressed predictive
    # bitstream, whose byte counts bodies under-report. SAMPLE depth (the
    # white level) comes from BitsPerSample: 12-bit data stored in 16-bit
    # words is the common Olympus layout, and white=65535 there would
    # develop ~16x too dark.
    if total >= npix * 2:
        storage = 16
    elif total == packed_need:
        storage = 12
    else:
        storage = 0  # olympus-compressed
    bits = int(ifd.get1(T_BITS, storage or 12) or storage or 12)
    if not 8 <= bits <= 16:
        raise ValueError(f"ORF: implausible BitsPerSample {bits}")
    if storage:
        data = _read_strips(tf, ifd, height, width, storage, "le")
    else:
        # Compressed ORFs are single-strip in practice and their byte
        # counts are unreliable (bodies write short counts); read from the
        # strip offset to end-of-file and let the bit reader consume what
        # the stream needs.
        from .olympus import decode_olympus
        if not offsets:
            raise ValueError("ORF: raw IFD has no strip offsets")
        off = int(offsets[0])
        if not 0 <= off < len(tf.buf):
            raise ValueError("ORF: strip offset out of range")
        data = decode_olympus(bytes(tf.buf[off:]), width, height)

    if ifd.get1(T_PHOTOMETRIC) == 32803:
        cfa = _cfa_from_ifd(ifd)
    else:
        cfa = _ORF_PATTERNS.get((model or "").strip().upper())
        if cfa is None:
            raise ValueError(
                "ORF: raw IFD carries no CFA tags and no pattern is "
                "registered for this body (register_orf_pattern)")
    wb, cam2srgb, mn_blacks, valid_bits, mn_crop = _olympus_calibration(tf)
    wb = wb or (float("nan"),) * 4
    black, white = _vendor_levels(model, bits)
    blacks = mn_blacks if mn_blacks is not None else (black,) * 4
    if valid_bits is not None:
        white = (1 << valid_bits) - 1
    if cam2srgb is not None:
        from .cameras import xyz_to_cam_from_cam2srgb

        xyz_to_cam = xyz_to_cam_from_cam2srgb(cam2srgb)
    else:
        xyz_to_cam = xyz_to_cam_for(make, model)
    crops = (0, 0, 0, 0)
    if mn_crop is not None:
        cl, ct, cw, ch = mn_crop
        if ct + ch <= height and cl + cw <= width:
            crops = (ct, width - cl - cw, height - ct - ch, cl)
    return RawImage(
        width=width, height=height, cpp=1, crops=crops,
        blacklevels=blacks, whitelevels=(white,) * 4,
        wb_coeffs=wb, xyz_to_cam=xyz_to_cam,
        orientation=_orientation(tf), cfa=cfa, data=data,
        make=make, model=model)


def _pentax_makernote(tf: TiffFile):
    """The Pentax maker note as (Ifd, endian), or None.

    Two public header flavors: classic 'AOC\\0' + 2 bytes (the IFD starts
    at note+6, offsets are FILE-relative, container byte order) and newer
    'PENTAX \\0' + 'II'/'MM' (the IFD starts at note+10, offsets are
    NOTE-relative, own byte order)."""
    for ifd in tf.ifds:
        if T_MAKERNOTE not in ifd.entries:
            continue
        typ, count, off = ifd.entries[T_MAKERNOTE]
        head = bytes(tf.buf[off:off + 10])
        try:
            if head.startswith(b"AOC\0"):
                entries, _ = tf._read_ifd(off + 6 - tf.base)
                return Ifd(tf, entries, off), tf.endian
            if head.startswith(b"PENTAX \0"):
                order = {b"II": "<", b"MM": ">"}.get(head[8:10])
                if order is None:
                    return None
                sub = object.__new__(TiffFile)
                sub.buf = tf.buf
                sub.base = off
                sub.endian = order
                sub.ifds = []
                entries, _ = sub._read_ifd(10)
                return Ifd(sub, entries, off), order
        except ValueError:
            return None  # bounds-checked walk failed: ignore the note
    return None


def _pentax_calibration(tf: TiffFile):
    """(wb_coeffs, blacklevels|None, huff_spec_bytes|None, endian) from
    the Pentax maker note: tag 0x0201 white point (4 u16, stored R G G B),
    0x0200 black point (4 u16, same order), 0x0220 the compressed-stream
    Huffman table."""
    found = _pentax_makernote(tf)
    wb = (float("nan"),) * 4
    blacks = None
    spec = None
    endian = tf.endian
    if found is None:
        return wb, blacks, spec, endian
    mn, endian = found
    wp = mn.get(0x0201)
    if wp and len(wp) >= 4 and float(wp[1]) > 0:
        g = float(wp[1])
        wb = (float(wp[0]) / g, 1.0, float(wp[3]) / g, float("nan"))
    bp = mn.get(0x0200)
    if bp and len(bp) >= 4:
        # stored R G1 G2 B -> (R, G1, B, G2); gofloat uses channel 0
        blacks = (int(bp[0]), int(bp[1]), int(bp[3]), int(bp[2]))
    spec = mn.raw_bytes(0x0220)
    return wb, blacks, spec, endian


def read_pef(path: str) -> RawImage:
    """Pentax PEF: standard TIFF-EP with a CFA raw IFD. Uncompressed
    (compression 1, 16-bit or 12/14-bit big-endian packed) and
    pentax-compressed (65535, the Huffman predictive bitstream --
    pentax.decode_pentax; the per-body table ships in maker-note tag
    0x0220, table-less bodies use the public default tree). WB and black
    points come from maker-note tags 0x0201/0x0200 where present (the
    classic unencrypted blocks); otherwise WB falls back to the neutral
    estimate."""
    with open(path, "rb") as f:
        buf = f.read()
    tf = TiffFile(buf)
    make, model = _make_model(tf)
    if "PENTAX" not in make.upper() and "RICOH" not in make.upper():
        raise ValueError("not a Pentax PEF")

    ifd = _raw_cfa_ifd(tf)
    width = ifd.get1(T_WIDTH)
    height = ifd.get1(T_LENGTH)
    if not width or not height or width * height > 500_000_000:
        raise ValueError("PEF: missing/implausible raw dimensions")
    bits = ifd.get1(T_BITS, 16)
    compression = ifd.get1(T_COMPRESSION, 1)
    wb, mn_blacks, huff_spec, mn_endian = _pentax_calibration(tf)
    if compression == 1:
        packing = "be" if bits in (12, 14) or tf.endian == ">" else "le"
        data = _read_strips(tf, ifd, height, width, bits, packing)
    elif compression == 65535:
        from .pentax import PentaxHuff, decode_pentax
        huff = (PentaxHuff.from_spec(huff_spec, mn_endian)
                if huff_spec else PentaxHuff.default())
        offsets = ifd.get(T_STRIP_OFFSETS) or []
        if not offsets:
            raise ValueError("PEF: compressed strip has no offset")
        off = int(offsets[0])
        if not 0 <= off < len(tf.buf):
            raise ValueError("PEF: strip offset out of range")
        # Single strip in practice; byte counts can undershoot the
        # stream, so read to end-of-file and let the bit reader consume
        # what it needs (dcraw seeks and reads the same way).
        data = decode_pentax(bytes(tf.buf[off:]), width, height, huff)
    else:
        raise ValueError(f"PEF: unrecognized compression {compression}")
    black, white = _vendor_levels(model, bits)
    if mn_blacks is not None and black == 0:
        blacks = mn_blacks
    else:
        blacks = (black,) * 4
    return RawImage(
        width=width, height=height, cpp=1, crops=(0, 0, 0, 0),
        blacklevels=blacks, whitelevels=(white,) * 4,
        wb_coeffs=wb, xyz_to_cam=xyz_to_cam_for(make, model),
        orientation=_orientation(tf), cfa=_cfa_from_ifd(ifd), data=data,
        make=make, model=model)


def read_tiffep(path: str) -> RawImage:
    """Generic TIFF-EP CFA reader: the standards-compliant fallback for
    TIFF-based raws without a dedicated decoder (Epson ERF, Leica RWL,
    Mamiya MEF, Leaf MOS, uncompressed Samsung SRW / Kodak KDC/DCR,
    Hasselblad 3FR...). Requires a real CFA IFD (photometric 32803 with
    pattern tags) and an uncompressed layout -- 16-bit words (strip
    extent >= 2 bytes/px, tolerating count padding) or 12/14-bit packed
    (extent >= the group-rounded packed size the unpackers enforce).
    Vendor-compressed payloads raise with the format
    and compression named (a recognized gap, never a PIL error). WB is
    left NaN (neutral-estimate fallback): maker-note layouts are vendor
    specific and a wrong guess silently tints the image.

    The reference covers these bodies through rawloader
    (the reference's src/pipeline.rs:264)."""
    with open(path, "rb") as f:
        buf = f.read()
    tf = TiffFile(buf)
    make, model = _make_model(tf)
    ifd = _raw_cfa_ifd(tf)
    width = ifd.get1(T_WIDTH)
    height = ifd.get1(T_LENGTH)
    if not width or not height or width * height > 500_000_000:
        raise ValueError("TIFF-EP: missing/implausible raw dimensions")
    compression = ifd.get1(T_COMPRESSION, 1)
    if compression == 7 and "HASSELBLAD" in make.upper():
        # Compressed 3FR: TIFF compression 7, but the strip payload is
        # the Hasselblad variant of lossless JPEG (Phase One bit order,
        # paired-column predictor) — see hasselblad.py.
        if int(ifd.get1(277, 1) or 1) != 1:
            raise ValueError(
                f"3FR ({model}): multi-shot files (SamplesPerPixel > 1) "
                "are not supported")
        offsets = ifd.get(T_STRIP_OFFSETS) or []
        if len(offsets) != 1:
            raise ValueError(
                f"3FR ({model}): expected a single JPEG strip, got "
                f"{len(offsets)}")
        from .hasselblad import decode_hasselblad

        off = int(offsets[0])
        if not 0 <= off < len(tf.buf):
            raise ValueError("3FR: strip offset out of range")
        # Byte counts can undershoot (dcraw seeks and reads the same
        # way); the bit reader consumes what it needs.
        data = decode_hasselblad(bytes(tf.buf[off:]), width, height)
        black, white = _vendor_levels(model, 16)
        return RawImage(
            width=width, height=height, cpp=1, crops=(0, 0, 0, 0),
            blacklevels=(black,) * 4, whitelevels=(white,) * 4,
            wb_coeffs=(float("nan"),) * 4,
            xyz_to_cam=xyz_to_cam_for(make, model),
            orientation=_orientation(tf), cfa=_cfa_from_ifd(ifd),
            data=data, make=make, model=model)
    if compression == 32772 and "SAMSUNG" in make.upper():
        # Samsung NX 12-bit compressed (dcraw samsung_load_raw semantics;
        # see samsung.py for the algorithm + provenance notes).
        from .samsung import decode_samsung12

        offsets = ifd.get(T_STRIP_OFFSETS) or []
        counts = ifd.get(T_STRIP_BYTECOUNTS) or []
        if len(offsets) != 1:
            raise ValueError(
                f"SRW 32772 ({model}): expected one strip, got "
                f"{len(offsets)}")
        off = int(offsets[0])
        cnt = int(counts[0]) if counts else len(tf.buf) - off
        tf._check(off, cnt, "SRW 32772 strip")
        data = decode_samsung12(bytes(tf.buf[off:off + cnt]), width, height)
        black, white = _vendor_levels(model, 12)
        return RawImage(
            width=width, height=height, cpp=1, crops=(0, 0, 0, 0),
            blacklevels=(black,) * 4, whitelevels=(white,) * 4,
            wb_coeffs=(float("nan"),) * 4,
            xyz_to_cam=xyz_to_cam_for(make, model),
            orientation=_orientation(tf), cfa=_cfa_from_ifd(ifd),
            data=data, make=make, model=model)
    if compression == 65000 and "KODAK" in make.upper():
        # Kodak DCR/KDC per-run DPCM (dcraw kodak_65000_load_raw
        # semantics; see kodak.py for the algorithm + provenance notes).
        from .kodak import decode_kodak65000

        offsets = ifd.get(T_STRIP_OFFSETS) or []
        counts = ifd.get(T_STRIP_BYTECOUNTS) or []
        if len(offsets) != 1:
            raise ValueError(
                f"KDC/DCR 65000 ({model}): expected one strip, got "
                f"{len(offsets)}")
        off = int(offsets[0])
        cnt = int(counts[0]) if counts else len(tf.buf) - off
        tf._check(off, cnt, "KDC/DCR 65000 strip")
        data = decode_kodak65000(bytes(tf.buf[off:off + cnt]),
                                 width, height)
        black, white = _vendor_levels(model, 12)
        return RawImage(
            width=width, height=height, cpp=1, crops=(0, 0, 0, 0),
            blacklevels=(black,) * 4, whitelevels=(white,) * 4,
            wb_coeffs=(float("nan"),) * 4,
            xyz_to_cam=xyz_to_cam_for(make, model),
            orientation=_orientation(tf), cfa=_cfa_from_ifd(ifd),
            data=data, make=make, model=model)
    if compression in (65001, 65002) and "KODAK" in make.upper():
        raise ValueError(
            f"KDC/DCR: Kodak compression {compression} "
            f"({'YCbCr' if compression == 65001 else 'interpolated RGB'}) "
            "is not supported (only the 65000 CFA scheme decodes); "
            "convert to DNG")
    if compression == 7:
        # Lossless-JPEG strips: Mamiya MEF (ZD) and Leaf MOS compressed
        # backs store standard ITU-T T.81 process-14 (SOF3) streams in
        # their strips — the same public codec as LJ92 DNGs (lj92.py,
        # with its native twin). rawloader reaches both through its
        # shared LJPEG decompressor (mef.rs / mos.rs feed strips to it
        # and copy rows out flat). RECALLED-SEMANTICS SURFACE: "the
        # payload is plain SOF3 with components interleaved into
        # consecutive columns" is the recalled claim, pending the
        # realfile harness (docs/MIGRATION.md); the codec itself is
        # spec-pinned and encoder-round-tripped.
        return _read_tiffep_lj92(tf, ifd, make, model, width, height)
    if compression != 1:
        raise ValueError(
            f"TIFF-EP raw ({make} {model}): vendor-compressed payload "
            f"(compression {compression}) has no decoder here; convert "
            "to DNG")
    bits = int(ifd.get1(T_BITS, 16) or 16)
    if not 8 <= bits <= 16:
        raise ValueError(f"TIFF-EP: implausible BitsPerSample {bits}")
    counts = ifd.get(T_STRIP_BYTECOUNTS) or []
    total = sum(int(c) for c in counts)
    npix = width * height
    rps = int(ifd.get1(T_ROWS_PER_STRIP, height) or height)
    nstrips = (height + rps - 1) // rps

    def _strip_rows(i):
        return min(rps, height - i * rps)

    # Per-strip packed extents use the same group-rounded formulas the
    # unpackers enforce (12-bit: 2 px in 3 bytes; 14-bit: 4 px in 7), so
    # a layout that passes here cannot then fail inside _read_strips.
    if bits == 12:
        packed_need = sum((_strip_rows(i) * width + 1) // 2 * 3
                          for i in range(nstrips))
    elif bits == 14:
        packed_need = sum((_strip_rows(i) * width + 3) // 4 * 7
                          for i in range(nstrips))
    else:
        packed_need = None
    if total >= npix * 2:
        data = _read_strips(tf, ifd, height, width, 16,
                            "be" if tf.endian == ">" else "le")
    elif packed_need is not None and total >= packed_need:
        data = _read_strips(tf, ifd, height, width, bits,
                            "be" if tf.endian == ">" else "le")
    else:
        raise ValueError(
            f"TIFF-EP raw ({make} {model}): strip extent {total} matches "
            "neither 16-bit words nor a packed layout (vendor-compressed "
            "or truncated); convert to DNG")
    black, white = _vendor_levels(model, bits)
    return RawImage(
        width=width, height=height, cpp=1, crops=(0, 0, 0, 0),
        blacklevels=(black,) * 4, whitelevels=(white,) * 4,
        wb_coeffs=(float("nan"),) * 4,
        xyz_to_cam=xyz_to_cam_for(make, model),
        orientation=_orientation(tf), cfa=_cfa_from_ifd(ifd), data=data,
        make=make, model=model)


def _read_tiffep_lj92(tf, ifd, make, model, width, height) -> RawImage:
    """TIFF-EP CFA raw with lossless-JPEG (SOF3) strips: the compressed
    Mamiya MEF / Leaf MOS tier. Each strip is an independent T.81
    process-14 stream; decoded samples fill the raster row-major with
    components interleaved into consecutive columns (ljw*ncomp == strip
    width for the 1/2/4-component CFA flavors), so any stream whose pixel
    count matches the strip's rows*width lays out flat — rawloader's
    mef.rs/mos.rs copy-out behavior. 3-component (YCbCr sRAW-style)
    streams are refused: they are not a CFA raster.

    Reference surface: the reference's src/pipeline.rs:264 (rawloader)."""
    from .lj92 import decode as lj92_decode, sof_ncomp, sof_precision

    offsets = ifd.get(T_STRIP_OFFSETS) or []
    counts = ifd.get(T_STRIP_BYTECOUNTS) or []
    if not offsets:
        raise ValueError(f"TIFF-EP LJ92 ({make} {model}): no strips")
    rps = int(ifd.get1(T_ROWS_PER_STRIP, height) or height)
    nstrips = (height + rps - 1) // rps
    if len(offsets) != nstrips:
        raise ValueError(
            f"TIFF-EP LJ92 ({make} {model}): {len(offsets)} strips for "
            f"{nstrips} expected from RowsPerStrip {rps}")
    data = np.empty((height, width), np.uint16)
    prec = 16
    for i, off in enumerate(offsets):
        off = int(off)
        cnt = int(counts[i]) if i < len(counts) else len(tf.buf) - off
        tf._check(off, cnt, "TIFF-EP LJ92 strip")
        payload = bytes(tf.buf[off:off + cnt])
        if sof_ncomp(payload) == 3:
            raise ValueError(
                f"TIFF-EP LJ92 ({make} {model}): 3-component (YCbCr) "
                "stream is not a CFA raster; only a dedicated sRAW-style "
                "decoder could develop it")
        prec = sof_precision(payload)
        rows = min(rps, height - i * rps)
        arr = lj92_decode(payload)
        if arr.size != rows * width:
            raise ValueError(
                f"TIFF-EP LJ92 ({make} {model}): strip {i} decodes "
                f"{arr.shape[0]}x{arr.shape[1]} = {arr.size} samples, "
                f"expected {rows}x{width}")
        data[i * rps:i * rps + rows] = arr.reshape(rows, width)
    black, white = _vendor_levels(model, prec)
    return RawImage(
        width=width, height=height, cpp=1, crops=(0, 0, 0, 0),
        blacklevels=(black,) * 4, whitelevels=(white,) * 4,
        wb_coeffs=(float("nan"),) * 4,
        xyz_to_cam=xyz_to_cam_for(make, model),
        orientation=_orientation(tf), cfa=_cfa_from_ifd(ifd), data=data,
        make=make, model=model)
